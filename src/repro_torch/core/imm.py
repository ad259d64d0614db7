"""IMM influence maximization on fused-BPT samples (PyTorch port of
``repro.core.imm``).

Sample θ RRR sets by fused reverse BPTs, then greedy max-k-cover over the
collection; the cover fraction × n estimates σ(S).  Each greedy pick is one
`kernels.ops.cover_counts` launch over the whole ``(B, V, W)`` stack (the
batch sum fused into the kernel), an argmax on the device (first index on
ties, as ``jnp.argmax``) and a mask update — no host sync until the caller
reads the seeds.

Sampling is pluggable through the sketch-pool protocol: any object with
``num_colors``, ``master_seed``, ``ensure(num_batches)`` and
``visited_stack()`` (`serve.influence.sketch_store.SketchStore`) can back
``estimate_theta`` / ``run_imm``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import bitmask, rrr
from repro_torch.graph import csr
from repro_torch.kernels import ops


# --------------------------------------------------------------- θ bound
def _log_comb(n: int, k: int) -> float:
    return (math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1))


def _adjusted_ell(n: int, ell: float) -> float:
    return ell * (1 + math.log(2) / math.log(n))


def _lam_star_coeff(n: int, k: int, ell_adj: float) -> float:
    """λ*(ε) = coeff / ε² (Tang et al. Thm 1); ``ell_adj`` pre-adjusted."""
    alpha = math.sqrt(ell_adj * math.log(n) + math.log(2))
    beta = math.sqrt((1 - 1 / math.e)
                     * (_log_comb(n, k) + ell_adj * math.log(n) + math.log(2)))
    return 2 * n * ((1 - 1 / math.e) * alpha + beta) ** 2


def theta_bound(n: int, k: int, eps: float, ell: float = 1.0) -> int:
    """IMM λ*/LB worst-case sample count with LB = 1 (Tang et al. Thm 1)."""
    return int(math.ceil(
        _lam_star_coeff(n, k, _adjusted_ell(n, ell)) / eps ** 2))


def eps_bound_for_theta(n: int, k: int, theta: int, ell: float = 1.0,
                        opt_lb: float = 1.0) -> float:
    """Coverage-error bound a pool of ``theta`` RRR samples certifies — the
    exact inverse of the ``estimate_theta`` sample-count bound."""
    theta = max(int(theta), 1)
    return math.sqrt(_lam_star_coeff(n, k, _adjusted_ell(n, ell))
                     / (theta * max(opt_lb, 1.0)))


def estimate_theta(g: csr.Graph, k: int, eps: float, ell: float = 1.0,
                   num_colors: int | None = None,
                   master_seed: int | None = None,
                   max_batches_per_phase: int = 64,
                   g_rev: csr.Graph | None = None,
                   pool=None, spec=None, mesh=None,
                   sampler=None) -> tuple[int, list]:
    """IMM sampling phase: iterative-halving lower bound on OPT → θ.

    Returns (θ, batches generated so far), which the selection phase
    reuses.  ``pool``: optional sketch pool that owns sampling;
    ``spec``/``mesh``: `repro_torch.sampling.SamplerSpec` and, for the
    mesh backends, `distributed.comm.Mesh` of the pool-less path;
    ``sampler``: a prebuilt sampler (overrides ``spec``).
    """
    from repro_torch import sampling

    spec = sampling.resolve_spec(spec, num_colors=num_colors,
                                 master_seed=master_seed)
    num_colors = spec.num_colors
    n = g.num_vertices
    ell = _adjusted_ell(n, ell)
    eps_prime = math.sqrt(2) * eps
    lam_prime = ((2 + 2 * eps_prime / 3)
                 * (_log_comb(n, k) + ell * math.log(n)
                    + math.log(math.log2(max(n, 4))))
                 * n / eps_prime ** 2)
    if pool is None and sampler is None:
        sampler = sampling.make_sampler(g, spec, mesh, g_rev=g_rev)
    batches: list[rrr.RRRBatch] = []

    def grow(want: int) -> list[rrr.RRRBatch]:
        if pool is not None:
            return _pool_take(pool, want)
        if len(batches) < want:
            batches.extend(sampler.sample_many(range(len(batches), want)))
        return batches

    lb = 1.0
    for i in range(1, max(int(math.log2(n)), 1)):
        x = n / (2 ** i)
        theta_i = int(math.ceil(lam_prime / x))
        want = min(-(-theta_i // num_colors), max_batches_per_phase)
        cur = grow(want)
        vis = (pool.visited_stack()[:len(cur)] if pool is not None
               else rrr.stack_visited(cur))
        _, cov = greedy_max_cover(vis, k, num_colors)
        if n * cov >= (1 + eps_prime) * x:
            lb = n * cov / (1 + eps_prime)
            break
    lam_star = _lam_star_coeff(n, k, ell) / eps ** 2
    return int(math.ceil(lam_star / lb)), (batches if pool is None
                                           else pool.ensure(0))


def _pool_take(pool, want: int) -> list:
    """Exactly ``want`` batches from a sketch pool, as the sample prefix;
    raises when the pool's capacity cannot supply them (the θ bound must
    not weaken silently)."""
    got = pool.ensure(want)
    if len(got) < want:
        raise ValueError(
            f"sketch pool capacity {len(got)} < {want} batches required by "
            "IMM sampling — raise the pool's max_batches / memory budget, "
            "or lower θ (larger eps, smaller theta_cap)")
    return got[:want]


# ------------------------------------------------------ greedy max-k-cover
def initial_active(num_batches: int, num_colors: int,
                   device) -> torch.Tensor:
    """(B, W) all-colours-uncovered mask (tail bits past num_colors zeroed)."""
    tail = bitmask.tail_mask_tensor(num_colors, device)
    return tail.expand(num_batches, -1).contiguous()


def greedy_extend(visited: torch.Tensor, active: torch.Tensor, k: int):
    """Extend a partial cover by ``k`` greedy picks from ``active``, on the
    device: each pick computes all vertices' marginal gains, argmaxes them
    (first index on ties) and strips the winner's colours from the active
    mask.  Returns (seeds (k,) int32 device tensor, new active (B, W),
    uncovered colour count int32 device scalar)."""
    seeds = torch.zeros(k, dtype=torch.int64, device=visited.device)
    act = active
    for i in range(k):
        sel = torch.argmax(ops.cover_counts(visited, act))
        seeds[i] = sel
        act = act & ~visited.index_select(1, sel.view(1)).squeeze(1)
    uncovered = bitmask.popcount(act).sum(dtype=torch.int32)
    return seeds.to(torch.int32), act, uncovered


def greedy_max_cover(visited: torch.Tensor, k: int, num_colors: int):
    """Greedy max-k-cover over a (B, V, W) RRR collection.
    Returns (seeds (k,) int32 numpy, covered fraction float)."""
    b = visited.shape[0]
    theta = b * num_colors
    seeds, _, uncovered = greedy_extend(
        visited, initial_active(b, num_colors, visited.device), k)
    return seeds.cpu().numpy(), (theta - int(uncovered)) / theta


def greedy_max_cover_ref(visited: torch.Tensor, k: int, num_colors: int):
    """Host-loop greedy for equivalence tests: per-pick host argmax
    (``np.argmax``, first index on ties) over the same counts."""
    b = visited.shape[0]
    theta = b * num_colors
    active = initial_active(b, num_colors, visited.device)
    seeds = []
    for _ in range(k):
        sel = int(np.argmax(ops.cover_counts(visited, active).cpu().numpy()))
        seeds.append(sel)
        active = active & ~visited[:, sel, :]
    covered = theta - int(bitmask.popcount(active).sum())
    return np.asarray(seeds, np.int32), covered / theta


def coverage_of(visited: torch.Tensor, seeds, num_colors: int) -> float:
    """Fraction of RRR sets hit by ``seeds`` (σ(S) ≈ n × this)."""
    b = visited.shape[0]
    active = initial_active(b, num_colors, visited.device)
    for s in np.asarray(seeds):
        active = active & ~visited[:, int(s), :]
    theta = b * num_colors
    return (theta - int(bitmask.popcount(active).sum())) / theta


# --------------------------------------------------------------- end-to-end
@dataclasses.dataclass(frozen=True)
class IMMResult:
    seeds: np.ndarray
    sigma_estimate: float       # expected influence of the seed set
    theta: int
    coverage: float
    num_batches: int
    fused_edge_visits: int
    unfused_edge_visits: int


def run_imm(g: csr.Graph, k: int, eps: float = 0.3, *, ell: float = 1.0,
            num_colors: int | None = None, master_seed: int | None = None,
            theta_cap: int | None = 100_000, pool=None,
            spec=None, mesh=None) -> IMMResult:
    """Full IMM: θ estimation → top-up sampling → greedy selection.

    ``pool``: optional sketch pool; batches come from and stay in it.  A
    fresh pool with the same ``master_seed``/``num_colors`` reproduces the
    pool-less result exactly (batch ``b`` is a pure function of
    ``(graph, master_seed, b)``); selection uses the first ``⌈θ/colors⌉``
    slots either way.  ``spec`` chooses the backend of the pool-less path
    and ``mesh`` backs its mesh backends (every rank of the mesh calls
    this; greedy selection runs on each rank over the whole collection).
    """
    from repro_torch import sampling

    explicit_spec = spec is not None
    spec = sampling.resolve_spec(spec, num_colors=num_colors,
                                 master_seed=master_seed)
    num_colors = spec.num_colors
    if pool is not None:
        if explicit_spec and getattr(pool, "spec", None) is not None \
                and pool.spec.diffusion != spec.diffusion:
            raise ValueError(f"pool diffusion {pool.spec.diffusion!r} != "
                             f"requested {spec.diffusion!r}")
        if pool.num_colors != num_colors:
            raise ValueError(f"pool colors {pool.num_colors} != {num_colors}")
    sampler = None
    if pool is None:
        sampler = sampling.make_sampler(g, spec, mesh)
    theta, batches = estimate_theta(g, k, eps, ell, spec=spec,
                                    pool=pool, sampler=sampler)
    if theta_cap:
        theta = min(theta, theta_cap)
    want = -(-theta // num_colors)
    if pool is not None:
        batches = _pool_take(pool, want)
        visited = pool.visited_stack()[:want]
    else:
        if len(batches) < want:
            batches.extend(sampler.sample_many(range(len(batches), want)))
        batches = batches[:want]
        visited = rrr.stack_visited(batches)
    seeds, cov = greedy_max_cover(visited, k, num_colors)
    return IMMResult(
        seeds=seeds, sigma_estimate=cov * g.num_vertices,
        theta=len(batches) * num_colors, coverage=cov,
        num_batches=len(batches),
        # Skip the -1 "not instrumented" sentinels (tiled/kernel batches).
        fused_edge_visits=sum(b.fused_edge_visits for b in batches
                              if b.fused_edge_visits >= 0),
        unfused_edge_visits=sum(b.unfused_edge_visits for b in batches
                                if b.unfused_edge_visits >= 0))


def simulate_influence(g: csr.Graph, seeds, num_trials: int = 512,
                       master_seed: int = 77) -> float:
    """σ(S) by forward IC: one colour per trial, frontier starts at all of S.

    Under IC, activations from several seeds in one realization are a BFS
    from the seed *set* on the realized subgraph, so one colour seeded at
    every s ∈ S is a correct per-trial sample.  Up to 256 trials ride as
    the colours of one fused traversal; the round that starts at trial t
    draws with counter seed ``master_seed + t``."""
    n = g.num_vertices
    seeds = np.asarray(seeds, np.int64).reshape(-1)
    colors = min(num_trials, 256)
    total, trials_done = 0, 0
    while trials_done < num_trials:
        c = min(colors, num_trials - trials_done)
        fr = bitmask.set_color(bitmask.make_mask(n, c, g.device),
                               torch.from_numpy(np.repeat(seeds, c)),
                               torch.arange(c).repeat(len(seeds)))
        res = _run_from_frontier(g, fr, c, master_seed + trials_done)
        total += int(bitmask.popcount(res).sum(dtype=torch.int64))
        trials_done += c
    return total / num_trials


def _run_from_frontier(g: csr.Graph, frontier: torch.Tensor,
                       num_colors: int, seed: int,
                       max_levels: int = 64) -> torch.Tensor:
    """Fused traversal from an arbitrary initial frontier; returns the
    visited mask (the frontier at the level cap counts as visited)."""
    from repro_torch.core import traversal

    visited = torch.zeros_like(frontier)
    level = 0
    while level < max_levels and bitmask.any_set(frontier):
        frontier, visited, _ = traversal.fused_step(g, frontier, visited,
                                                    level, seed)
        level += 1
    return visited | frontier
