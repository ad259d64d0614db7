"""Fused traversals under the Linear Threshold (LT) diffusion model (PyTorch
port of ``repro.core.lt``).

RIS under LT uses the live-edge equivalence: each vertex selects at most
one in-edge, edge (v→u) with probability w(v, u) (Σ_v w(v, u) ≤ 1, none
with 1 − Σw), and an RRR set is the reverse-reachable set over the
selected edges.  The selection is per (vertex, colour): vertex u's chosen
in-edge for colour c is a counter hash of (seed, 0x17, u, c), with no
level in the counters, so it is fixed for the whole traversal and the
level loop stays bitmask propagation.

The CDF prefix sums (``selection_cum_before``) and the weight
normalisation are host numpy, float64 where the reference sums in float64,
so every float32 value equals the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bitmask, rng
from repro_torch.core.traversal import _scatter_or, init_frontier
from repro_torch.graph import csr

_SELECT_LEVEL = 0x17      # the selection hash's fixed "level" counter


def normalize_lt_weights(g: csr.Graph) -> csr.Graph:
    """Scale each vertex's IN-edge weights to sum ≤ 1: w(v, u) =
    prob(v, u) / max(1, Σ_in prob(·, u)), summed in float64.
    Order-preserving: only ``prob`` changes, so CSR edge ids (the RNG
    counters) are kept.  The result is a new graph, marked as carrying the
    invariant (`declare_normalized`)."""
    e = g.num_edges
    dst = g.dst[:e].cpu().numpy()
    prob = g.prob[:e].cpu().numpy().astype(np.float64)
    in_sum = np.zeros(g.num_vertices)
    np.add.at(in_sum, dst, prob)
    scale = 1.0 / np.maximum(in_sum[dst], 1.0)
    new_prob = g.prob.clone()
    new_prob[:e] = torch.from_numpy((prob * scale).astype(np.float32)).to(
        g.device)
    return declare_normalized(dataclasses.replace(g, prob=new_prob, cache={}))


def declare_normalized(g: csr.Graph) -> csr.Graph:
    """Mark ``g`` as carrying the LT invariant (per-destination in-weights
    summing to ≤ 1), so `normalized` uses it as it is; returns ``g``.
    `normalize_lt_weights` and `stream.apply_delta(..., lt_normalized=
    True)` mark what they return."""
    # A marker, not the graph: a graph in its own cache is a reference
    # cycle, which would hold its stacks until the cyclic collector ran.
    g.cache["lt_normalized"] = "self"
    return g


def normalized(g_rev: csr.Graph) -> csr.Graph:
    """The LT-normalised form of ``g_rev``: ``g_rev`` itself when it
    carries the invariant (`declare_normalized`), else
    ``normalize_lt_weights(g_rev)`` built once per graph object.  Every LT
    sampler over one graph shares the normalised graph and, through its
    cache, its tile stacks.

    The reference normalises again whatever it is handed, and a second
    pass is not a no-op in float32: at n = 65,536, p = 0.25 it moves 278
    of 382,080 weights by one ulp.  So the reference's store clones, its
    restores onto a normalised ``g_rev`` and its streamed pairs each sample
    a graph of their own, while the port's share one (and so one set of
    stacks) and a streamed pool equals its cold rebuild by construction.
    ``tests/test_torch_stream.py`` pins the difference."""
    g_lt = g_rev.cache.get("lt_normalized")
    if g_lt is None:
        g_lt = g_rev.cache["lt_normalized"] = normalize_lt_weights(g_rev)
    return g_rev if isinstance(g_lt, str) else g_lt


def selection_cum_before(g: csr.Graph) -> np.ndarray:
    """(E_pad,) float32: Σ of the in-edge probabilities before each edge in
    its destination's CDF (host, float64 sums).  Seed-independent."""
    e_pad, e = g.padded_edges, g.num_edges
    dst_np = g.dst[:e].cpu().numpy()
    prob_np = g.prob[:e].cpu().numpy().astype(np.float64)
    order = np.argsort(dst_np, kind="stable")
    sorted_prob = prob_np[order]
    sorted_dst = dst_np[order]
    csum = np.cumsum(sorted_prob)
    group_start = np.searchsorted(sorted_dst, sorted_dst, side="left")
    prefix = csum - sorted_prob                       # Σ p before i (global)
    cum_before_sorted = prefix - prefix[group_start]  # per-dst prefix
    cum_before = np.zeros(e_pad, np.float32)
    cum_before[order] = cum_before_sorted.astype(np.float32)
    return cum_before


def selection_uniforms(seed, vertices: torch.Tensor,
                       lanes: torch.Tensor) -> torch.Tensor:
    """float32 ``u(vertex, colour)`` for every pair of the broadcast
    ``vertices`` × ``lanes`` — the one uniform a destination's in-edges
    share per colour."""
    return rng.uniform_from_u32(
        rng.hash_u32(seed, _SELECT_LEVEL, vertices, lanes))


def selection_mask_from_cb(g: csr.Graph, cb: torch.Tensor, num_colors: int,
                           seed) -> torch.Tensor:
    """(E_pad, W) int32: bit c of edge e set iff e is dst[e]'s live edge for
    colour c, i.e. ``cb[e] ≤ u(dst[e], c) < cb[e] + p[e]`` (float32 add and
    compares, as the reference).  ``cb`` is ``selection_cum_before(g)`` on
    ``g``'s device."""
    dev = g.device
    lo = cb.to(torch.float32)[:, None]
    hi = (cb.to(torch.float32) + g.prob)[:, None]
    words = []
    for w in range(bitmask.num_words(num_colors)):
        lanes = torch.arange(w * 32, w * 32 + 32, device=dev)[None, :]
        u = selection_uniforms(seed, g.dst[:, None], lanes)
        words.append(rng.pack_bool_word((u >= lo) & (u < hi)))
    return torch.stack(words, -1)


def lt_traversal(g: csr.Graph, sel: torch.Tensor, starts, num_colors: int,
                 max_levels: int) -> torch.Tensor:
    """Level loop over a fixed live-edge selection ``sel`` (E_pad, W);
    returns visited (V, W).  Only edges that carry a colour this level are
    scattered."""
    frontier = init_frontier(g.num_vertices, num_colors, starts, g.device)
    visited = torch.zeros_like(frontier)
    src, dst = g.src.to(torch.int64), g.dst.to(torch.int64)
    level = 0
    while level < max_levels and bitmask.any_set(frontier):
        visited |= frontier
        contrib = frontier[src] & sel & ~visited[dst]
        live = torch.nonzero((contrib != 0).any(1)).squeeze(1)
        frontier = _scatter_or(torch.zeros_like(visited), dst[live],
                               contrib[live]) & ~visited
        level += 1
    return visited | frontier


def run_fused_lt(g: csr.Graph, starts, num_colors: int, seed,
                 max_levels: int = 64) -> torch.Tensor:
    """Fused LT traversal: visited (V, W), column c = LT RRR set c."""
    cb = torch.from_numpy(selection_cum_before(g)).to(g.device)
    sel = selection_mask_from_cb(g, cb, num_colors, seed)
    return lt_traversal(g, sel, starts, num_colors, max_levels)


def run_fused_lt_block(g: csr.Graph, cb: torch.Tensor, starts, seeds,
                       num_colors: int, max_levels: int = 64) -> torch.Tensor:
    """A block of LT batches, each with its own selection: starts (B, C) /
    seeds (B,) → visited (B, V, W); ``cb`` as `selection_mask_from_cb`."""
    return torch.stack([
        lt_traversal(g, selection_mask_from_cb(g, cb, num_colors, int(sd)),
                     st, num_colors, max_levels)
        for st, sd in zip(starts, seeds)])
