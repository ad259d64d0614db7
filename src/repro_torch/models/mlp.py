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

from repro_torch.distributed import fsdp
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
        if isinstance(gen, common.ShapeOnly):    # a skeleton: nothing drawn
            return w
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


def _counts(ids: torch.Tensor, e: int) -> torch.Tensor:
    """``torch.bincount(ids, minlength=e)`` (int64, ids < e) as a
    scatter-add, whose output shape does not depend on the data, so that
    it runs on meta tensors too (the dry-run)."""
    return torch.zeros(e, dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids, dtype=torch.int64))


def _route(router, xt, k: int, mesh=None):
    """Float32 router: (gate (T, k) renormalised, idx (T, k), aux), slots in
    descending probability, the lower expert first on ties.  With a
    training ``mesh`` (every rank holding rows of its own) the aux loss is
    the global one: the token counts and probability sums are summed over
    the ranks before their product."""
    probs = torch.softmax(xt.float() @ router, -1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :k], idx[:, :k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    e = probs.shape[-1]
    # Switch aux loss: e · Σ_e f_e · P_e
    counts = _counts(idx.reshape(-1), e)
    prob_sum, n = probs.sum(0), xt.shape[0]
    if mesh is not None:
        counts = mesh.psum(counts, mesh.axis_names)
        prob_sum = fsdp.psum(prob_sum, mesh)
        n *= fsdp.mesh_size(mesh)
    return gate, idx, e * (counts.float() / n * (prob_sum / n)).sum()


def _ranks(flat_e: torch.Tensor, e: int) -> torch.Tensor:
    """Each pair's rank among the pairs routed to its expert, in stream
    order (the reference's cumsum of one-hots, without the (N·k, E)
    tensor)."""
    order = torch.argsort(flat_e, stable=True)
    counts = _counts(flat_e, e)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(flat_e)
    pos[order] = torch.arange(flat_e.numel(), device=flat_e.device) \
        - starts[flat_e[order]]
    return pos


def _local_dispatch(xt, gate, idx, e: int, cap: int, before=None):
    """Capacity-bounded dispatch.  xt: (T, D); gate/idx: (T, k).  Returns
    (buf (E, rows, D), flat_e, pos, keep, tok), rows = cap.  ``before``
    (E,): the pairs other ranks routed to each expert ahead of these,
    which count toward the capacity (a pair is kept while ``pos +
    before`` is below it); the buffer then holds min(cap, T·k) rows an
    expert, which a kept pair's ``pos`` stays below."""
    t, d = xt.shape
    k = idx.shape[1]
    flat_e = idx.reshape(-1)
    pos = _ranks(flat_e, e)
    keep = pos < cap if before is None else pos + before[flat_e] < cap
    rows = cap if before is None else min(cap, t * k)
    tok = torch.arange(t, device=xt.device).repeat_interleave(k)
    # Kept pairs own distinct rows; dropped ones all go to one spare row.
    row = torch.where(keep, flat_e * rows + pos, e * rows)
    buf = xt.new_zeros((e * rows + 1, d))
    buf[row] = xt[tok]
    return buf[: e * rows].view(e, rows, d), flat_e, pos, keep, tok


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


def a2a_route(cfg: ModelConfig, mesh, length: int) -> bool:
    """Whether the reference's dispatcher takes the a2a form for tokens of
    ``length`` on ``mesh``: ``moe_impl == "a2a"`` and a ``"model"`` axis of
    size > 1 that divides the length and E."""
    if cfg.moe_impl != "a2a" or mesh is None \
            or "model" not in mesh.axis_names:
        return False
    s = mesh.shape["model"]
    return s > 1 and length % s == 0 and cfg.num_experts % s == 0


def moe_forward(p, x, cfg: ModelConfig, mesh=None):
    """MoE dispatcher: x (B, L, D) → ((B, L, D), aux load-balance loss).

    With a `comm.Mesh` on which `a2a_route` holds, the expert-parallel
    form: every rank holds the whole ``x`` and ``p`` (as the reference's
    caller does), works on its token block and its experts
    (`token_block`, `expert_shard`), and the output blocks are gathered
    back.  Otherwise the one-device scatter."""
    if a2a_route(cfg, mesh, x.shape[1]):
        out, aux = _moe_forward_a2a(expert_shard(p, cfg, mesh),
                                    token_block(x, mesh), cfg, mesh)
        return gather_tokens(out, mesh), aux
    return _moe_forward_scatter(p, x, cfg)


def moe_forward_sharded(p, x, cfg: ModelConfig, mesh):
    """The MoE of sharded training: x (B/R, L, D) holds this rank's rows
    (rank q of the R = mesh size ranks the q-th run of the microbatch's
    rows, `distributed.fsdp.local_rows`); returns ((B/R, L, D), the
    global aux loss), what the reference's dispatcher computes on the
    whole microbatch under its mesh.

    On the a2a route (`a2a_route`) ``p`` holds this rank's E/S whole
    experts (`distributed.fsdp.gather_module`): one all-to-all over
    ``model`` turns the rows of ranks (d, ·) into the reference's block
    (d, m) (data rank d's rows, sequence block m), `_moe_forward_a2a`
    runs on it, and the transposed all-to-all brings the rows back.
    Otherwise the whole layer, and the scatter of the global dispatch
    (`_moe_forward_scatter` with the mesh)."""
    if not a2a_route(cfg, mesh, x.shape[1]):
        return _moe_forward_scatter(p, x, cfg, mesh)
    s = mesh.shape["model"]
    bl, L, d = x.shape
    blk = x.reshape(bl, s, L // s, d).transpose(0, 1).contiguous()
    blk = fsdp.all_to_all(blk, mesh, "model").reshape(s * bl, L // s, d)
    out, aux = _moe_forward_a2a(p, blk, cfg, mesh)
    out = fsdp.all_to_all(out.reshape(s, bl, L // s, d).contiguous(), mesh,
                          "model")
    return out.transpose(0, 1).reshape(bl, L, d), aux


def moe_forward_serve(p, x, cfg: ModelConfig, mesh, rows=None):
    """The MoE of serving on a ``mesh`` (`models.decode`): x (B_r, L, D)
    holds the rows of this rank's data position, the same on every
    ``model`` rank; ``rows`` is the mesh along the data axes
    (`comm.AxesView`), None when the rows are not split.  The reference's
    dispatcher under its mesh: where `a2a_route` holds (a prefill) and
    the rows split, each ``model`` rank takes its sequence block, the
    reference's ``token_block``, and ``p`` holds its E/S whole experts
    (`fsdp.gather_module`): `_moe_forward_a2a`, then the blocks gathered
    over ``model``; otherwise (a decode step) the global scatter over the
    data axes (`moe_forward_sharded` on ``rows``: one device's capacity
    and picks), or with unsplit rows the one-device scatter."""
    if rows is not None and a2a_route(cfg, mesh, x.shape[1]):
        s, m = mesh.shape["model"], mesh.axis_index("model")
        bl, L, d = x.shape
        blk = x[:, m * (L // s):(m + 1) * (L // s)].contiguous()
        out, aux = _moe_forward_a2a(p, blk, cfg, mesh)
        out = mesh.all_gather(out.transpose(0, 1).contiguous(), "model")
        return out.transpose(0, 1), aux
    if rows is not None:
        return moe_forward_sharded(p, x, cfg, rows)
    return _moe_forward_scatter(p, x, cfg)


def _moe_forward_scatter(p, x, cfg: ModelConfig, mesh=None):
    """x: (B, L, D) → (B, L, D), aux load-balance loss (module
    docstring).  With a training ``mesh`` (``x`` this rank's rows), the
    scatter of the whole microbatch: the capacity is the global token
    count's; a (token, slot) pair's rank in its expert is its rank among
    this rank's pairs plus the pairs every earlier rank routed there (one
    all-gather of E counts), so that exactly the reference's pairs are
    kept; the kept rows run through the experts here (an expert's rows do
    not meet) and the aux loss is the global one (`_route`)."""
    b, L, d = x.shape
    t, e, k = b * L, cfg.num_experts, cfg.top_k
    xt = x.reshape(t, d)
    gate, idx, aux = _route(p["router"], xt, k, mesh)
    before = None
    if mesh is not None:
        counts = _counts(idx.reshape(-1), e)
        before = fsdp.all_gather_ranks(counts, mesh)[:mesh.rank].sum(0)
        t *= fsdp.mesh_size(mesh)
    buf, flat_e, pos, keep, _ = _local_dispatch(
        xt, gate, idx, e, capacity(t, cfg), before)
    out = _combine(_experts(p, buf, cfg), flat_e, pos, keep, gate, k)
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
    aux = fsdp.psum(aux, mesh, axes) / math.prod(mesh.shape[a] for a in axes)

    buf, flat_e, pos, keep, _ = _local_dispatch(xt, gate, idx, e, cap)
    # (E, cap, D) → (S, E/S, cap, D) → a2a → recv[j] = rank j's rows for
    # my experts → (E/S, S·cap, D)
    recv = fsdp.all_to_all(buf.view(s, el, cap, d), mesh, "model")
    recv = recv.transpose(0, 1).reshape(el, s * cap, d)
    out_buf = _experts(p, recv, cfg)
    # combine: the transposed route back to the source ranks
    back = fsdp.all_to_all(
        out_buf.view(el, s, cap, d).transpose(0, 1).contiguous(), mesh,
        "model")
    out = _combine(back.view(e, cap, d), flat_e, pos, keep, gate, k)
    if cfg.num_shared_experts:
        out = out + mlp_forward(p["shared"], xt, cfg)
    return out.view(bl, ll, d).to(x.dtype), aux
