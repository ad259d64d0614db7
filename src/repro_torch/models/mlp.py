"""Dense MLP and Mixture-of-Experts layers of the LM substrate (the
reference's ``models/mlp.py``).

Dense: gated (SwiGLU-style) or plain, weights ``w1 (d, f)``, ``w2 (f, d)``
and, gated, ``w3 (d, f)``.

MoE: capacity-bounded dispatch (Switch-style): each token's top-k experts
by router probability; a (token, slot) pair's rank in its expert follows
the flattened (token, slot) stream, and pairs ranked past the capacity
``max(int(n·k / E · capacity_factor), 1)`` are dropped (combine weight 0).
Weights: ``router (d, E)`` in float32 whatever the model's dtype,
``experts_w1``/``experts_w3 (E, d, fe)``, ``experts_w2 (E, fe, d)`` and an
optional ``shared`` dense MLP.  Expert products are ``torch.bmm``, as the
reference leaves its ``einsum`` to XLA.  Top-k is a stable descending sort
(``lax.top_k`` puts the lower index first on ties; ``torch.topk`` does
not).  Dispatch writes each kept pair to its unique (expert, rank) row and
combine sums a token's k contributions as one reshape, so neither uses
atomics and the result does not change from run to run.

``moe_forward(p, x, cfg, mesh)`` runs the expert-parallel all-to-all form
(`_moe_forward_a2a`) where the reference's dispatcher would: ``moe_impl ==
"a2a"`` and a ``"model"`` axis of size > 1 that divides L and E; else the
one-device scatter.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import common
from repro_torch.models.config import ModelConfig


# ------------------------------------------------------------------- dense
def _mlp_tensors(gen: torch.Generator, cfg: ModelConfig, d_ff: int | None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = common.dtype_of(cfg.dtype)
    p = {"w1": common.dense_init(gen, d, (f,), dt),
         "w2": common.dense_init(gen, f, (d,), dt)}
    if cfg.gated_mlp:
        p["w3"] = common.dense_init(gen, d, (f,), dt)
    return p


def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             d_ff: int | None = None):
    """One layer's MLP weights on ``gen``'s device, drawn in the
    reference's order (w1, w2, then w3 when gated)."""
    return common.param_dict(_mlp_tensors(gen, cfg, d_ff))


def mlp_forward(p, x, cfg: ModelConfig):
    act = common.activation_fn(cfg.activation)
    h = act(x @ p["w1"])
    if cfg.gated_mlp:
        h = h * (x @ p["w3"])
    return h @ p["w2"]


# --------------------------------------------------------------------- MoE
def shared_d_ff(cfg: ModelConfig) -> int:
    """Width of the shared expert's MLP (the reference's ``init_moe``)."""
    return (cfg.moe_d_ff * cfg.num_shared_experts if cfg.moe_d_ff
            else cfg.d_ff)


def init_moe(gen: torch.Generator, cfg: ModelConfig):
    """One MoE layer's weights on ``gen``'s device: the router in float32,
    each expert stack drawn one expert at a time (the float32 transient is
    one expert's, not the stack's) and cast to the config's dtype."""
    d, e = cfg.d_model, cfg.num_experts
    fe = cfg.moe_d_ff or cfg.d_ff
    dt = common.dtype_of(cfg.dtype)

    def stack(in_dim, out_dim):
        w = torch.empty((e, in_dim, out_dim), dtype=dt, device=gen.device)
        for i in range(e):
            w[i] = common.dense_init(gen, in_dim, (out_dim,), dt)
        return w

    p = {"router": common.dense_init(gen, d, (e,), torch.float32),
         "experts_w1": stack(d, fe), "experts_w2": stack(fe, d)}
    if cfg.gated_mlp:
        p["experts_w3"] = stack(d, fe)
    if cfg.num_shared_experts:
        p["shared"] = _mlp_tensors(gen, cfg, shared_d_ff(cfg))
    return common.param_dict(p)


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Rows per expert for ``tokens`` tokens, in Python floats exactly as
    the reference computes it."""
    return max(int(tokens * cfg.top_k / cfg.num_experts
                   * cfg.capacity_factor), 1)


def _route(router, xt, k: int):
    """Float32 router: (gate (T, k) renormalised, idx (T, k), aux), slots in
    descending probability, the lower expert first on ties."""
    probs = torch.softmax(xt.float() @ router, -1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :k], idx[:, :k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    e = probs.shape[-1]
    # Switch aux loss: e · Σ_e f_e · P_e
    token_frac = torch.bincount(idx.reshape(-1), minlength=e).float() \
        / xt.shape[0]
    aux = e * (token_frac * probs.mean(0)).sum()
    return gate, idx, aux


def _ranks(flat_e: torch.Tensor, e: int) -> torch.Tensor:
    """Each pair's rank among the pairs routed to its expert, in stream
    order (the reference's cumsum of one-hots, without the (N·k, E)
    tensor)."""
    order = torch.argsort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(flat_e)
    pos[order] = torch.arange(flat_e.numel(), device=flat_e.device) \
        - starts[flat_e[order]]
    return pos


def _local_dispatch(xt, gate, idx, e: int, cap: int):
    """Capacity-bounded dispatch.  xt: (T, D); gate/idx: (T, k).  Returns
    (buf (E, cap, D), flat_e, pos, keep, tok)."""
    t, d = xt.shape
    k = idx.shape[1]
    flat_e = idx.reshape(-1)
    pos = _ranks(flat_e, e)
    keep = pos < cap
    tok = torch.arange(t, device=xt.device).repeat_interleave(k)
    # Kept pairs own distinct rows; dropped ones all go to one spare row.
    row = torch.where(keep, flat_e * cap + pos, e * cap)
    buf = xt.new_zeros((e * cap + 1, d))
    buf[row] = xt[tok]
    return buf[: e * cap].view(e, cap, d), flat_e, pos, keep, tok


def _experts(p, buf, cfg: ModelConfig):
    """(E', C, D) rows through their experts' MLPs → (E', C, D)."""
    act = common.activation_fn(cfg.activation)
    h = act(torch.bmm(buf, p["experts_w1"]))
    if cfg.gated_mlp:
        h = h * torch.bmm(buf, p["experts_w3"])
    return torch.bmm(h, p["experts_w2"])


def _combine(out_buf, flat_e, pos, keep, gate, k: int):
    """Each token's kept expert outputs, gate-weighted and summed: (T, D)."""
    e, cap, d = out_buf.shape
    g = out_buf.reshape(e * cap, d)[flat_e * cap + torch.where(keep, pos, 0)]
    g = torch.where(keep[:, None], g, torch.zeros((), dtype=g.dtype,
                                                  device=g.device))
    w = (gate.reshape(-1) * keep).to(g.dtype)
    return (g * w[:, None]).view(-1, k, d).sum(1)


def moe_forward(p, x, cfg: ModelConfig, mesh=None):
    """MoE dispatcher: x (B, L, D) → ((B, L, D), aux load-balance loss).

    With a `comm.Mesh` whose ``"model"`` axis (size > 1) divides L and E,
    and ``moe_impl == "a2a"``, the expert-parallel form: every rank holds
    the whole ``x`` and ``p`` (as the reference's caller does), works on its
    token block and its experts (`token_block`, `expert_shard`), and the
    output blocks are gathered back.  Otherwise the one-device scatter."""
    if (cfg.moe_impl == "a2a" and mesh is not None
            and "model" in mesh.axis_names):
        s = mesh.shape["model"]
        if x.shape[1] % s == 0 and cfg.num_experts % s == 0 and s > 1:
            out, aux = _moe_forward_a2a(expert_shard(p, cfg, mesh),
                                        token_block(x, mesh), cfg, mesh)
            return gather_tokens(out, mesh), aux
    return _moe_forward_scatter(p, x, cfg)


def _moe_forward_scatter(p, x, cfg: ModelConfig):
    """x: (B, L, D) → (B, L, D), aux load-balance loss (module
    docstring)."""
    b, L, d = x.shape
    n = b * L
    xt = x.reshape(n, d)
    gate, idx, aux = _route(p["router"], xt, cfg.top_k)
    buf, flat_e, pos, keep, _ = _local_dispatch(
        xt, gate, idx, cfg.num_experts, capacity(n, cfg))
    out = _combine(_experts(p, buf, cfg), flat_e, pos, keep, gate,
                   cfg.top_k)
    if cfg.num_shared_experts:
        out = out + mlp_forward(p["shared"], xt, cfg)
    return out.view(b, L, d).to(x.dtype), aux


# --------------------------------------------------- expert parallel (a2a)
def dp_axes(mesh) -> tuple:
    """The token axes besides ``model``, in the reference's order."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _dp_position(mesh) -> tuple[int, int]:
    """(this rank's block index over the data axes, their total size),
    the first axis major."""
    index, size = 0, 1
    for a in dp_axes(mesh):
        index = index * mesh.shape[a] + mesh.axis_index(a)
        size *= mesh.shape[a]
    return index, size


def token_block(x, mesh):
    """This rank's block of (B, L, D) tokens: batch split over the data
    axes, sequence over ``model`` (the reference's ``in_specs``)."""
    b, L, _ = x.shape
    s = mesh.shape["model"]
    i, dp = _dp_position(mesh)
    if b % dp or L % s:
        raise ValueError(f"tokens (B {b}, L {L}) do not split over the data "
                         f"axes ({dp}) and model ({s})")
    m = mesh.axis_index("model")
    return x[i * (b // dp):(i + 1) * (b // dp),
             m * (L // s):(m + 1) * (L // s)]


def gather_tokens(out, mesh):
    """The inverse of `token_block`: every rank's block, assembled."""
    out = mesh.all_gather(out.transpose(0, 1).contiguous(), "model")
    out = out.transpose(0, 1)
    for a in reversed(dp_axes(mesh)):
        out = mesh.all_gather(out.contiguous(), a)
    return out


def expert_shard(p, cfg: ModelConfig, mesh) -> dict:
    """This rank's view of a whole layer's weights: its E/S experts over
    ``model`` (no copy), the router and shared expert as they are."""
    el = cfg.num_experts // mesh.shape["model"]
    lo = mesh.axis_index("model") * el
    return {k: (v[lo:lo + el] if k.startswith("experts_") else v)
            for k, v in p.items()}


def _moe_forward_a2a(p, x, cfg: ModelConfig, mesh):
    """Expert parallelism with explicit all-to-all (classic EP, the
    paper's MPI_Alltoallv step), run on every rank of ``mesh``.

    ``x``: this rank's token block (B/dp, L/S, D) (`token_block`); ``p``:
    its E/S experts (``experts_*`` leading with E/S) and the replicated
    router and shared expert.  Capacity is per rank.  Dispatch: the local
    (E, cap, D) buffer goes out in S blocks of E/S experts, one all-to-all
    over ``model``; each rank runs its experts on the (E/S, S·cap, D) rows
    it received, and the transposed all-to-all brings them back.  aux is
    averaged over ``model`` and the data axes.  Returns (out block, aux)."""
    bl, ll, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    s = mesh.shape["model"]
    el = e // s
    if p["experts_w1"].shape[0] != el:
        raise ValueError(f"a rank holds E/S = {el} experts, got "
                         f"{p['experts_w1'].shape[0]}")
    axes = ("model",) + dp_axes(mesh)
    t = bl * ll
    cap = capacity(t, cfg)
    xt = x.reshape(t, d)
    gate, idx, aux = _route(p["router"], xt, k)
    aux = mesh.psum(aux, axes) / math.prod(mesh.shape[a] for a in axes)

    buf, flat_e, pos, keep, _ = _local_dispatch(xt, gate, idx, e, cap)
    # (E, cap, D) → (S, E/S, cap, D) → a2a → recv[j] = rank j's rows for
    # my experts → (E/S, S·cap, D)
    recv = mesh.all_to_all(buf.view(s, el, cap, d), "model")
    recv = recv.transpose(0, 1).reshape(el, s * cap, d)
    out_buf = _experts(p, recv, cfg)
    # combine: the transposed route back to the source ranks
    back = mesh.all_to_all(
        out_buf.view(el, s, cap, d).transpose(0, 1).contiguous(), "model")
    out = _combine(back.view(e, cap, d), flat_e, pos, keep, gate, k)
    if cfg.num_shared_experts:
        out = out + mlp_forward(p["shared"], xt, cfg)
    return out.view(bl, ll, d).to(x.dtype), aux
