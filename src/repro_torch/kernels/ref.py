"""Plain PyTorch versions of the port's CUDA kernels.

Each function defines its kernel's result.  The wrappers in `kernels.ops`
run these on CPU tensors; the tests hold them against the reference's
Pallas kernels, and ``chip_smoke.py`` holds the CUDA kernels against them
on the card.  They repeat the kernels' arithmetic and are no yardstick of
speed.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitmask, rng
from repro_torch.core.bitmask import MASK32


def _tile_expand(gate, prob, tile_src, tile_dst, frontier, visited,
                 chunk_tiles: int, tile_ids=None):
    """Shared scaffolding of the tile-expansion plain versions (the
    reference's ``kernels/ref.py::_tile_expand``):

        out[dst] = OR over tiles( OR_i frontier[src_i] & gate ) & ~visited[dst]

    Only (tile, row i, lane j) slots that can contribute are evaluated:
    ``prob > 0`` (every gate is false on a zero slot) and a source row
    with a live frontier word.  ``gate(t, i, j, p, dst_row)`` returns the
    ``(M, W, 32)`` bool lanes of those ``M`` slots (``t`` are tile ids into
    ``prob``).  The tiles are every tile of the stacks, or the ids listed
    in ``tile_ids``; they go in chunks of ``chunk_tiles`` to bound the
    ``(M, W, 32)`` transients."""
    T = prob.shape[1]
    n = prob.shape[0] if tile_ids is None else tile_ids.shape[0]
    w = frontier.shape[1]
    dev = frontier.device
    fr_live = (frontier != 0).any(1)
    rows_in_block = torch.arange(T, device=dev)
    out_lanes = torch.zeros(visited.shape[0] * w, 32, dtype=torch.uint8,
                            device=dev)
    for c0 in range(0, n, chunk_tiles):
        if tile_ids is None:
            tid = torch.arange(c0, min(c0 + chunk_tiles, n), device=dev)
            p = prob[c0:c0 + chunk_tiles]
        else:
            tid = tile_ids[c0:c0 + chunk_tiles].to(torch.int64)
            p = prob[tid]
        src_blk = tile_src[tid].to(torch.int64)
        live = fr_live[src_blk[:, None] * T + rows_in_block[None, :]]
        t, i, j = torch.nonzero((p > 0) & live[:, :, None], as_tuple=True)
        if t.numel() == 0:
            continue
        src_row = src_blk[t] * T + i
        dst_row = tile_dst[tid[t]].to(torch.int64) * T + j
        lanes = gate(tid[t], i, j, p[t, i, j], dst_row)
        contrib = frontier[src_row] & bitmask.pack_bits(lanes)   # (M, W)
        _or_rows(out_lanes, dst_row, contrib)
    return _packed(out_lanes, visited) & ~visited


def _or_rows(out_lanes, dst_row, contrib):
    """OR the ``(M, W)`` words ``contrib`` into rows ``dst_row`` of
    ``out_lanes`` (one uint8 per output bit, ``(rows·W, 32)``)."""
    w = contrib.shape[1]
    flat = (dst_row[:, None] * w
            + torch.arange(w, device=contrib.device)[None, :])
    out_lanes.scatter_reduce_(
        0, flat.reshape(-1, 1).expand(-1, 32),
        bitmask.unpack_bits(contrib).to(torch.uint8).reshape(-1, 32), "amax")


def _packed(out_lanes, visited):
    return bitmask.pack_bits(out_lanes.view(visited.shape[0],
                                            visited.shape[1], 32).bool())


def _slot_entries(slots, tile_ids):
    """int64 indices of the entries of the listed tiles (ascending, tile by
    tile), or None for every entry: the entries a list-mode launch walks."""
    if tile_ids is None:
        return None
    t = tile_ids.to(torch.int64)
    start = slots.slot_ptr[t].to(torch.int64)
    count = slots.slot_ptr[t + 1].to(torch.int64) - start
    first = torch.cumsum(count, 0) - count            # offset in the walk
    return (torch.repeat_interleave(start - first, count)
            + torch.arange(int(count.sum()), device=t.device))


def _slot_expand(gate, slots, frontier, visited, tile_ids, chunk: int):
    """Shared scaffolding of the slot-list plain versions, the kernels'
    arithmetic entry by entry: ``pending = frontier[src_row] &
    ~visited[dst_row]``, the draws of the pending colours (``gate(e)`` →
    ``(M, W)`` words of the colours that cross entries ``e``, pending or
    not), and their OR into ``out[dst_row]``.  The entries are every entry
    or those of the listed tiles (`_slot_entries`), in chunks of
    ``chunk``."""
    w = frontier.shape[1]
    dev = frontier.device
    entries = _slot_entries(slots, tile_ids)
    n = slots.num_entries if entries is None else entries.numel()
    out_lanes = torch.zeros(visited.shape[0] * w, 32, dtype=torch.uint8,
                            device=dev)
    for c0 in range(0, n, chunk):
        e = (torch.arange(c0, min(c0 + chunk, n), device=dev)
             if entries is None else entries[c0:c0 + chunk])
        dst = slots.dst_row[e].to(torch.int64)
        pending = (frontier[slots.src_row[e].to(torch.int64)]
                   & ~visited[dst])
        live = (pending != 0).any(1)
        if not bool(live.any()):
            continue
        e, dst, pending = e[live], dst[live], pending[live]
        _or_rows(out_lanes, dst, pending & gate(e))
    return _packed(out_lanes, visited)


def fused_expand_ref(prob, edge_id, tile_src, tile_dst, frontier, visited,
                     seed, level, *, tile_ids=None, chunk_tiles: int = 1024):
    """One level of tile-based IC expansion (replaces the reference's
    ``kernels/ref.py::fused_expand_ref``):

        out[dst] = OR over tiles( OR_i frontier[src_i] & Bernoulli_word(edge)
                   ) & ~visited[dst]

    Args:
      prob:     (nt, T, T) f32 tile activation probabilities (0 ⇒ no edge).
      edge_id:  (nt, T, T) int32 CSR edge ids (RNG counters).
      tile_src: (nt,) int32 source block per tile (indexes ``frontier``).
      tile_dst: (nt,) int32 destination block per tile (indexes ``visited``).
      frontier: (Vf, W) int32 packed colour mask (padded rows).
      visited:  (Vo, W) int32 — ALREADY folded with the current frontier.
      seed, level: RNG counters.
      tile_ids: optional ascending int32 ids of the tiles to walk (the
                sparse frontier's list); None walks every tile.

    Colours of a source row with an empty frontier word, and slots with
    ``prob ≤ 0`` (a uniform in [0, 1) is never below it), are never hashed.
    """
    w = frontier.shape[1]
    dev = frontier.device
    h_level = rng.level_prefix(seed, level)
    lanes = (torch.arange(w, device=dev)[:, None] * 32
             + torch.arange(32, device=dev)[None, :])        # (W, 32)

    def gate(t, i, j, p, dst_row):
        h_edge = rng._fold(h_level, bitmask.u32(edge_id[t, i, j]))
        bits = rng._fold(h_edge[:, None, None], lanes[None])
        return rng.uniform_from_u32(bits) < p[:, None, None]

    return _tile_expand(gate, prob, tile_src, tile_dst, frontier, visited,
                        chunk_tiles)


def fused_expand_slots_ref(slots, frontier, visited, seed, level, *,
                           tile_ids=None, chunk: int = 1 << 16):
    """`fused_expand_ref`'s function over the IC slot list
    (`core.tiles.ic_slot_list`), as ``csrc/fused_expand.cu`` computes it:
    per entry, the pending colours of its source row not visited at its
    destination, one fold of the edge id, one draw per colour
    (``uniform(fold(h_edge, c)) < prob``).  ``tile_ids`` lists tiles of
    the layout (ascending original ids; None: every tile); ``frontier`` and
    ``visited`` as `fused_expand_ref`."""
    w = frontier.shape[1]
    h_level = rng.level_prefix(seed, level)
    lanes = (torch.arange(w, device=frontier.device)[:, None] * 32
             + torch.arange(32, device=frontier.device)[None, :])

    def gate(e):
        h_edge = rng._fold(h_level, bitmask.u32(slots.key[e]))
        bits = rng._fold(h_edge[:, None, None], lanes[None])
        return bitmask.pack_bits(rng.uniform_from_u32(bits)
                                 < slots.value[e][:, None, None])

    return _slot_expand(gate, slots, frontier, visited, tile_ids, chunk)


def q_cell_ids(tile, i, j, tile_size: int):
    """The quantised kernel's RNG counter of slot ``(i, j)`` (source row,
    destination lane) of tile ``tile``: ``(tile·T² + i·T + j) mod 2³²``,
    int64 holding the uint32 value the reference computes in wrapping
    uint32 arithmetic (``fused_expand_q.py:78-79``).  Tile ids from
    2¹⁸ = 262,144 on wrap at T = 128."""
    return (tile * (tile_size * tile_size) + i * tile_size + j) & MASK32


def _q_draws(h_cell, hash_index, byte, q):
    """Accept lanes of the quantised draw: byte ``byte`` of
    ``fold(h_cell, hash_index)`` is at most ``q`` (uint8 compare)."""
    bits = rng._fold(h_cell, hash_index)
    return ((bits >> (8 * byte)) & 0xFF) <= q


def _bern_word_q(seed, level, cell_id, word, q8):
    """Packed 32-lane Bernoulli word from 8 hashes, 4 u8 lanes each (the
    reference's ``fused_expand_q.py::_bern_word_q``): lane ``c`` draws byte
    ``c % 4`` of ``hash_u32(seed, level, cell_id, word·8 + c // 4)`` and
    accepts when ``u8 ≤ q8 ∧ q8 > 0``.  Returns int32 bit patterns of
    ``q8``'s shape."""
    lane = torch.arange(32, device=q8.device)
    h_cell = rng._fold(rng.level_prefix(seed, level),
                       rng._as_u32(cell_id))[..., None]
    index = (rng._as_u32(word) * 8 + lane // 4) & MASK32
    q = q8.to(torch.int64)[..., None]
    return rng.pack_bool_word(_q_draws(h_cell, index, lane % 4, q) & (q > 0))


def fused_expand_q_ref(q8, tile_src, tile_dst, frontier, visited, seed,
                       level, *, tile_ids=None, chunk_tiles: int = 1024):
    """One quantised IC level over the tile layout (replaces the
    reference's ``fused_expand_q.py::fused_expand_q_ref``, and
    ``fused_expand_q_gathered`` with ``tile_ids``):

        out[dst] = OR over tiles( OR_i frontier[src_i]
                   & _bern_word_q(seed, level, cell(tile, i, j), w, q) )
                   & ~visited[dst]

    Args:
      q8:       (nt, T, T) uint8 thresholds (`core.tiles.quantized`).
      tile_src, tile_dst, frontier, visited, tile_ids: as
                `fused_expand_ref`; a listed tile draws with its own id
                (`q_cell_ids`), so a list gives the dense grid's bits on
                its tiles.

    Colour ``c`` of a slot is hash ``c // 4``, byte ``c % 4``.  Only slots
    with ``q > 0`` and a live source row are hashed."""
    w = frontier.shape[1]
    T = q8.shape[1]
    dev = frontier.device
    h_level = rng.level_prefix(seed, level)
    colour = (torch.arange(w, device=dev)[:, None] * 32
              + torch.arange(32, device=dev)[None, :])       # (W, 32)

    def gate(t, i, j, q, dst_row):
        h_cell = rng._fold(h_level, q_cell_ids(t, i, j, T))
        return _q_draws(h_cell[:, None, None], colour[None] >> 2,
                        colour[None] & 3, q.to(torch.int64)[:, None, None])

    return _tile_expand(gate, q8, tile_src, tile_dst, frontier, visited,
                        chunk_tiles, tile_ids)


def fused_expand_q_slots_ref(slots, frontier, visited, seed, level, *,
                             tile_ids=None, chunk: int = 1 << 16):
    """`fused_expand_q_ref`'s function over the quantised slot list
    (`core.tiles.q_slot_list`), as ``csrc/fused_expand_q.cu`` computes it:
    per entry one fold of its cell, then per pending nibble (four colours
    ``4k..4k+3`` of word ``w``) one hash ``fold(h_cell, 8w + k)`` whose
    byte ``b`` decides colour ``4k + b``: it crosses when the byte is at
    most ``q``.  Arguments as `fused_expand_slots_ref`."""
    w = frontier.shape[1]
    dev = frontier.device
    h_level = rng.level_prefix(seed, level)
    nibble = torch.arange(8 * w, device=dev)                  # 8w + k
    byte = torch.arange(4, device=dev)

    def gate(e):
        h_cell = rng._fold(h_level, bitmask.u32(slots.key[e]))
        q = slots.value[e].to(torch.int64)
        hashes = rng._fold(h_cell[:, None], nibble[None])       # (M, 8W)
        cross = ((hashes[..., None] >> (8 * byte)) & 0xFF) <= q[:, None, None]
        return bitmask.pack_bits(cross.view(-1, w, 32))

    return _slot_expand(gate, slots, frontier, visited, tile_ids, chunk)


def lt_selection_uniforms(seed, num_rows: int, num_colors: int,
                          row_base: int = 0, device="cpu") -> torch.Tensor:
    """(num_rows, W·32) f32 LT selection uniforms ``u(dst, colour)``
    (replaces the reference's ``kernels/ref.py::lt_selection_uniforms``):
    the (seed, 0x17, dst, colour) counters of
    `core.lt.selection_mask_from_cb`, one per destination row and colour
    lane, computed once per traversal.  ``row_base`` is the global vertex
    id of row 0 (0 on one device; a row shard's offset under a graph
    partition — the hash takes global ids).  Lanes pad to whole words;
    padded lanes never meet a live frontier bit."""
    from repro_torch.core import lt
    rows = row_base + torch.arange(num_rows, device=device)
    lanes = torch.arange(bitmask.num_words(num_colors) * 32, device=device)
    return lt.selection_uniforms(seed, rows[:, None], lanes[None, :])


def lt_select_expand_ref(prob, cb, tile_src, tile_dst, frontier, visited, u,
                         *, tile_ids=None, chunk_tiles: int = 1024):
    """One level of tile-based expansion under the LT live-edge selection
    (replaces the reference's ``kernels/ref.py::lt_select_expand_ref``):
    edge ``(src, dst)`` carries colour ``c`` iff
    ``cb ≤ u[dst, c] < cb + prob`` (one float32 add, two float32 compares).

    Args:
      prob:     (nt, T, T) f32 LT-normalised in-weights (0 ⇒ no edge).
      cb:       (nt, T, T) f32 selection-CDF prefix per slot
                (`core.tiles.lt_cb_tiles` of
                `core.lt.selection_cum_before`).
      tile_src, tile_dst, frontier, visited: as `fused_expand_ref`.
      u:        (Vo, W·32) f32 from `lt_selection_uniforms`, rows aligned
                with ``visited``.
      tile_ids: as `fused_expand_ref`.
    """
    w = frontier.shape[1]

    def gate(t, i, j, p, dst_row):
        lo = cb[t, i, j]
        hi = lo + p
        U = u[dst_row].view(-1, w, 32)
        return (U >= lo[:, None, None]) & (U < hi[:, None, None])

    return _tile_expand(gate, prob, tile_src, tile_dst, frontier, visited,
                        chunk_tiles, tile_ids)


def lt_select_expand_slots_ref(slots, frontier, visited, u, *,
                               tile_ids=None, chunk: int = 1 << 16):
    """`lt_select_expand_ref`'s function over the LT slot list
    (`core.tiles.lt_slot_list`), as ``csrc/lt_select_expand.cu`` computes
    it: per entry ``lo = key`` read as float32 (the cb prefix) and ``hi =
    lo + value`` (one float32 add), and a pending colour ``c`` crosses when
    ``lo ≤ u[dst_row, c] < hi``.  ``tile_ids``, ``frontier`` and
    ``visited`` as `fused_expand_slots_ref`; ``u`` as
    `lt_select_expand_ref`."""
    w = frontier.shape[1]

    def gate(e):
        lo = slots.key[e].view(torch.float32)
        hi = lo + slots.value[e]
        U = u[slots.dst_row[e].to(torch.int64)].view(-1, w, 32)
        return bitmask.pack_bits((U >= lo[:, None, None])
                                 & (U < hi[:, None, None]))

    return _slot_expand(gate, slots, frontier, visited, tile_ids, chunk)


def cover_counts_ref(visited, active):
    """Marginal-gain counts for max-k-cover, summed over the pool's batches
    (replaces ``kernels/ref.py::cover_counts_ref`` composed with the batch
    sum at ``imm.py:217`` / ``engine.py:112``):

        counts[v] = Σ_b Σ_w popcount(visited[b, v, w] & active[b, w])

    visited (B, V, W) int32 × active (B, W) → (V,) int32; a single batch
    may be passed as (V, W) × (W,).
    """
    if visited.dim() == 2:
        visited, active = visited[None], active[None]
    return bitmask.popcount(visited & active[:, None, :]).sum(
        (0, 2), dtype=torch.int32)


def cover_counts_multi_ref(visited, active_q):
    """`cover_counts_ref` for Q active masks per batch at once (the
    reference's ``lax.map`` over query slots at ``engine.py:109-113``):

        counts[q, v] = Σ_b Σ_w popcount(visited[b, v, w] & active_q[b, q, w])

    visited (B, V, W) int32 × active_q (B, Q, W) → (Q, V) int32."""
    counts = torch.zeros((active_q.shape[1], visited.shape[1]),
                         dtype=torch.int32, device=visited.device)
    for q in range(active_q.shape[1]):
        counts[q] = cover_counts_ref(visited, active_q[:, q])
    return counts


def _scores(q, k, causal, scale, kv_offset):
    """The (B, H, Lq, Lk) float32 scores s = (q·scale)·kᵀ of
    `flash_attention_ref`, a key at ``kp > qp + kv_offset`` at -1e30 under
    ``causal``; query head ``h`` reads KV head ``h // (H // KVH)``."""
    lq, h = q.shape[1], q.shape[2]
    kvh = k.shape[2]
    qf = q.float() * scale
    kf = k.float().repeat_interleave(h // kvh, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    if causal:
        qp = torch.arange(lq, device=q.device)[:, None] + kv_offset
        kp = torch.arange(k.shape[1], device=q.device)[None, :]
        s = s.masked_fill(kp > qp, -1e30)
    return s


def flash_attention_ref(q, k, v, *, causal=True, scale=None, kv_offset=0):
    """Attention with the function of the reference's Pallas kernel
    (``kernels/flash_attention.py::_flash_kernel``), as one plain softmax:

        s = (q·scale)·kᵀ in float32;  under ``causal`` a key at position
        ``kp > qp + kv_offset`` gets -1e30;  out = softmax(s)·v, cast to
        q's dtype.

    q (B, Lq, H, D); k, v (B, Lk, KVH, D), ``H`` a multiple of ``KVH``:
    query head ``h`` reads KV head ``h // (H // KVH)`` (grouped-query
    attention in place, the head order of ``q.reshape(b, L, kvh, g, hd)``).
    Rows attend every key up to ``qp + kv_offset`` (decode: one query at
    ``kv_offset = cur_len`` over a padded cache)."""
    h, d = q.shape[2], q.shape[3]
    scale = scale if scale is not None else d ** -0.5
    vf = v.float().repeat_interleave(h // v.shape[2], dim=2)
    p = torch.softmax(_scores(q, k, causal, scale, kv_offset), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def flash_attention_lse_ref(q, k, *, causal=True, scale=None, kv_offset=0):
    """What the ``wgmma`` forward and the ``decode`` route write to their
    ``lse`` output (``csrc/flash_prefill_wgmma.cu``,
    ``csrc/flash_decode.cu``): each query row's natural log-sum-exp of
    `flash_attention_ref`'s scores, float32 (B, H, Lq) (masked keys at
    -1e30 add nothing to it while a row sees one key or more)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return torch.logsumexp(_scores(q, k, causal, scale, kv_offset), dim=-1)


def flash_attention_bwd_ref(q, k, v, o, do, *, causal=True, scale=None,
                            lse=None):
    """The gradient of `flash_attention_ref` (``kv_offset`` 0, Lq == Lk)
    as the backward kernels compute it, in float32 with P materialised:

        s = (q·scale)·kᵀ, masked under ``causal``;  P = softmax(s);
        dv = Pᵀ·do;  dP = do·vᵀ;  Δ = rowsum(do ∘ o);  dS = P ∘ (dP - Δ);
        dq = scale · dS·k;  dk = scale · dSᵀ·q

    Without ``lse`` this is the ``simt`` route's function
    (``csrc/flash_attention_bwd.cu``).  With the forward's (B, H, L)
    ``lse`` (`flash_attention_lse_ref`) it is the ``wgmma`` route's
    (``csrc/flash_bwd_wgmma.cu``): P = exp(s - lse), and P and dS are
    rounded to the inputs' dtype before the products they feed, as that
    kernel rounds its register-A operands (the identity for float32).

    q, o and do (B, L, H, D); k and v (B, L, KVH, D), query head ``h``
    reading KV head ``h // (H // KVH)``, so dk and dv sum over each KV
    head's query heads.  Returns (dq, dk, dv) in the inputs' dtype."""
    b, L, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    scale = scale if scale is not None else d ** -0.5
    qf = q.float() * scale
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    dof = do.float()
    s = _scores(q, k, causal, scale, 0)
    if lse is None:
        p = torch.softmax(s, dim=-1)
        p_op = p
    else:
        p = torch.exp(s - lse.float()[..., None])
        p_op = p.to(q.dtype).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p_op, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (dof * o.float()).sum(-1).transpose(1, 2)       # (B, H, L)
    ds = p * (dp - delta[..., None])
    if lse is not None:
        ds = ds.to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dk = dk.reshape(b, L, kvh, g, d).sum(3)
    dv = dv.reshape(b, L, kvh, g, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of float32 ``x`` as the ``tf32x3`` kernels split it
    (``csrc/tf32x3.cuh``): hi is ``x`` rounded to TF32 as
    ``cvt.rna.tf32.f32`` rounds (to nearest, ties away from zero, the low
    13 mantissa bits cleared), lo is ``x - hi`` (exact in float32) rounded
    the same way; hi + lo holds ``x`` to about 2^-21 of ``|x|``."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    hi = rna(x.float())
    return hi, rna(x.float() - hi)


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor,
                  passes: int = 3) -> torch.Tensor:
    """``a @ b`` (float32, batched) with every product taken as the
    ``tf32x3`` kernels take it: both operands split (`tf32_split`), and for
    each slice of 8 along the summed axis lo_a·hi_b, then hi_a·lo_b, then
    hi_a·hi_b added into one float32 accumulator.  ``passes=1`` is
    hi_a·hi_b alone: single-pass TF32, which errs by about 1e-3 on
    attention's products where three passes keep float32's accuracy."""
    ahi, alo = tf32_split(a)
    bhi, blo = tf32_split(b)
    acc = torch.zeros(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
                      + (a.shape[-2], b.shape[-1]), dtype=torch.float32,
                      device=a.device)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        if passes == 3:
            acc = acc + alo[..., ks] @ bhi[..., ks, :]
            acc = acc + ahi[..., ks] @ blo[..., ks, :]
        acc = acc + ahi[..., ks] @ bhi[..., ks, :]
    return acc


def _heads_first(x, g: int = 1):
    """(B, L, KVH, D) → (B, KVH·g, L, D) float32, each KV head repeated for
    the ``g`` query heads that read it."""
    return x.float().repeat_interleave(g, dim=2).transpose(1, 2)


def _visible(lq: int, lk: int, causal: bool, device):
    if not causal:
        return torch.ones((lq, lk), dtype=torch.bool, device=device)
    return (torch.arange(lk, device=device)[None, :]
            <= torch.arange(lq, device=device)[:, None])


def flash_attention_tf32x3_ref(q, k, v, *, causal=True, scale=None,
                               passes: int = 3):
    """The ``tf32x3`` forward's numerics (``csrc/flash_prefill_tf32x3.cu``,
    ``kv_offset`` 0) in plain PyTorch: s = (q·scale)·kᵀ and exp(s - m)·v
    taken by `tf32x3_matmul`, the softmax in float32, out = that product
    over the row sum.  Returns (out (B, Lq, H, D), lse (B, H, Lq)) in
    float32.  ``passes=1`` takes every product as single-pass TF32.  Not
    on any path the port runs: the tests hold it against the reference to
    show that three passes keep the float32 limits and one does not."""
    b, lq, h, d = q.shape
    g = h // k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    s = tf32x3_matmul(_heads_first(q) * scale,
                      _heads_first(k, g).transpose(-1, -2), passes)
    s = s.masked_fill(~_visible(lq, k.shape[1], causal, q.device), -1e30)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    out = tf32x3_matmul(e, _heads_first(v, g), passes) / l
    return out.transpose(1, 2), (m + torch.log(l))[..., 0]


def flash_attention_bwd_tf32x3_ref(q, k, v, o, do, lse, *, causal=True,
                                   scale=None, passes: int = 3):
    """The ``tf32x3`` backward's numerics (``csrc/flash_bwd_tf32x3.cu``)
    in plain PyTorch: `flash_attention_bwd_ref` with ``lse`` (P = exp(s -
    lse)), every product taken by `tf32x3_matmul` and dk formed as the
    kernel forms it (dSᵀ·q, then times scale).  Float32 (dq, dk, dv);
    not on any path the port runs."""
    b, L, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    scale = scale if scale is not None else d ** -0.5
    qh, kh, vh = _heads_first(q), _heads_first(k, g), _heads_first(v, g)
    doh = _heads_first(do)
    s = tf32x3_matmul(qh * scale, kh.transpose(-1, -2), passes)
    vis = _visible(L, L, causal, q.device)
    p = torch.where(vis, torch.exp(s - lse.float()[..., None]), 0.0)
    dv = tf32x3_matmul(p.transpose(-1, -2), doh, passes)
    dp = tf32x3_matmul(doh, vh.transpose(-1, -2), passes)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    ds = p * (dp - delta[..., None])
    dq = tf32x3_matmul(ds, kh, passes) * scale
    dk = tf32x3_matmul(ds.transpose(-1, -2), qh, passes) * scale

    def per_kv(x):                # (B, H, L, D) → (B, L, KVH, D), GQA sum
        return x.transpose(1, 2).reshape(b, L, kvh, g, d).sum(3)

    return dq.transpose(1, 2), per_kv(dk), per_kv(dv)


def flash_decode_splitk_ref(q, k, v, *, chunk, causal=True, scale=None,
                            kv_offset=0):
    """`flash_attention_ref`'s function computed as the decode kernel
    splits it (``csrc/flash_decode.cu``): the ``Lk`` keys cut into chunks
    of ``chunk`` keys from key 0 (the last one short), a float32 partial
    per chunk — its max ``m`` over the visible keys, ``l = Σ exp(s - m)``
    and ``acc = Σ exp(s - m)·v`` — then merged with weights ``exp(m_c -
    max_c m_c)``: ``out = Σ w·acc / max(Σ w·l, 1e-30)``.  Keys past ``qp +
    kv_offset`` under ``causal`` take no part: a chunk without a visible
    key gives ``m = -inf, l = 0`` (masking its scores to -1e30 instead
    would give ``l`` = its length).  With ``chunk`` from
    `flash_attention.decode_split` this is the kernel's own split (which
    launches no chunk past the visible keys: those contribute nothing
    here).  Same layouts as `flash_attention_ref`; any ``Lq``."""
    b, lq, h, d = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    qf = q.float() * scale
    kf = k.float().repeat_interleave(h // kvh, dim=2)
    vf = v.float().repeat_interleave(h // kvh, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    kp = torch.arange(lk, device=q.device)[None, :]
    visible = torch.ones((lq, lk), dtype=torch.bool, device=q.device)
    if causal:
        visible = kp <= torch.arange(lq, device=q.device)[:, None] \
            + kv_offset
    ms, ls, accs = [], [], []
    for lo in range(0, lk, chunk):
        hi = min(lo + chunk, lk)
        sc = s[..., lo:hi].masked_fill(~visible[:, lo:hi], float("-inf"))
        m = sc.amax(-1)
        live = torch.isfinite(m)[..., None]
        p = torch.where(live, torch.exp(sc - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhqk,bkhd->bhqd", p, vf[:, lo:hi]))
    m_all = torch.stack(ms)
    top = m_all.amax(0)
    w = torch.where(torch.isfinite(m_all), torch.exp(m_all - top), 0.0)
    num = (w[..., None] * torch.stack(accs)).sum(0)
    den = (w * torch.stack(ls)).sum(0).clamp_min(1e-30)
    return (num / den[..., None]).permute(0, 2, 1, 3).to(q.dtype)
