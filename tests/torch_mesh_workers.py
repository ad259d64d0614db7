"""Rank programs of the port's CPU mesh tests (`test_torch_distributed.py`,
`test_torch_sharded_serve.py`, `test_torch_mesh_frontend.py`), run by
`repro_torch.launch.accel.spawn` on gloo worlds of CPU processes.  A
module of its own, importing torch and the port only, so that each rank
imports it (by name, from the tests directory on the path the parent
hands down) without the test files' jax.

Each function runs several checks in one world and returns plain numpy
and Python values; the tests compare them with the live reference
(`moe_world` backs `test_torch_moe.py`, `dp_world`
`test_torch_dp_train.py`, `train_mesh_world` and `train_restart_world`
the ``test_torch_train_mesh*.py`` files)."""
import dataclasses

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.core import rrr, traversal
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.distributed import traversal as dtrav
from repro_torch.graph import csr, generators, partition
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import init as model_init
from repro_torch.models import mlp, model
from repro_torch.optim import adamw, compress
from repro_torch.sampling import SamplerSpec, make_sampler

GRAPH = dict(n=500, degree=6.0, prob=0.3, seed=2)
T, COLORS, BATCHES, K = 32, 64, 5, 4


def graph(dev="cpu"):
    return csr.dedupe(generators.powerlaw_cluster(
        GRAPH["n"], GRAPH["degree"], prob=GRAPH["prob"], seed=GRAPH["seed"],
        device=dev))


def _masks(batches) -> np.ndarray:
    return np.stack([convert.masks_to_numpy(b.visited) for b in batches])


def _trim(words) -> list:
    return [[int(x) for x in np.trim_zeros(np.asarray(w), "b")]
            for w in words]


def distributed_world(rank, dev, world: int, cases: list) -> dict:
    """On one world of ``world`` ranks: the graph_parallel sampler for each
    of ``cases`` (shape, diffusion, frontier, capacity), sample-parallel
    traversal and distributed greedy on a (world, 1) mesh, the
    data_parallel sampler under LT with the sparse frontier, and
    `graph_parallel_traversal` over a (1, world) model axis."""
    g = graph(dev)
    g_rev = csr.transpose(g)
    out: dict = {"rank": rank, "num_edges": g.num_edges, "gp": []}
    for case in cases:
        mesh = make_mesh(case["shape"], ("data", "model"), device=dev)
        spec = SamplerSpec(diffusion=case["diffusion"],
                           backend="graph_parallel", num_colors=COLORS,
                           frontier=case["frontier"],
                           frontier_capacity=case.get("capacity", 0),
                           tile_size=T)
        sampler = make_sampler(g, spec, mesh)
        batches = sampler.sample_many(range(BATCHES))
        out["gp"].append(dict(case, masks=_masks(batches),
                              words=_trim(sampler.last_gather_words),
                              model_calls=mesh.stats["model"]["calls"]))

    mesh = make_mesh((world, 1), ("data", "model"), device=dev)
    b = 2 * world
    starts = np.stack([rrr.batch_starts(g.num_vertices, COLORS, 0, i)
                       for i in range(b)])
    seeds = rrr.batch_seeds(0, range(b))
    local = dtrav.sample_parallel_visited(g_rev, starts, seeds, COLORS, mesh)
    out["sp_local_shape"] = tuple(local.shape)
    out["sp_masks"] = convert.masks_to_numpy(mesh.all_gather(local, "data"))
    out["greedy"] = dtrav.distributed_greedy_max_cover(local, K, COLORS,
                                                       mesh)
    dp = make_sampler(g, SamplerSpec(diffusion="lt", backend="data_parallel",
                                     num_colors=COLORS, frontier="sparse",
                                     tile_size=T), mesh)
    out["dp_lt_sparse"] = _masks(dp.sample_many(range(BATCHES)))

    # A values-only delta (tombstones, none at the reversed graph's last
    # slot, which a delete would trim) rebinds graph_parallel in place.
    from repro_torch import stream
    rsrc, rdst, _ = g_rev.edges_numpy()
    delta = stream.EdgeDelta.deletes(rdst[:-1:7], rsrc[:-1:7])
    g2 = stream.apply_delta(g, delta)[0]
    g2_rev = stream.apply_delta(g_rev, delta.reversed())[0]
    mesh = make_mesh((1, world), ("data", "model"), device=dev)
    for diffusion in ("ic", "lt"):
        gp = make_sampler(g, SamplerSpec(diffusion=diffusion,
                                         backend="graph_parallel",
                                         num_colors=COLORS, tile_size=T),
                          mesh, g_rev=g_rev)
        gp.sample_many(range(2))
        rebound = gp.rebind(g2, g2_rev)
        out[f"rebind_{diffusion}"] = (rebound is gp,
                                      _masks(rebound.sample_many(range(3))))
    t = torch.full((2,), rank)
    nxt = (rank + 1) % world
    out["comm"] = dict(
        all_gather=mesh.all_gather(t, "model").tolist(),
        ppermute=[mesh.ppermute(t, "model", sh).tolist() for sh in (1, 2)],
        ragged=mesh.ppermute(torch.arange(rank + 1), "model", 1,
                             recv_shape=(nxt + 1,)).tolist(),
        psum=int(mesh.psum(t[:1], ("data", "model"))),
        pmax=int(mesh.pmax(t[:1], "model")),
        broadcast=int(mesh.broadcast(t[:1], "model", world - 1)))
    layout = partition.shard_layout(g_rev, T, world,
                                    mesh.axis_index("model"))
    slots = layout.slot_list(g_rev.edges_numpy()[2],
                             np.arange(g_rev.num_edges, dtype=np.int32), dev)
    vis, levels = dtrav.graph_parallel_traversal(
        layout, slots, starts[0], COLORS, int(seeds[0]), mesh)
    full = mesh.all_gather(vis, "model")[:g.num_vertices]
    out["gpt_mask"] = convert.masks_to_numpy(full)
    out["gpt_levels"] = levels
    out["gpt_single_levels"] = traversal.run_fused(
        g_rev, starts[0], COLORS, int(seeds[0])).stats.levels_run
    return out


def _answers(engine, k: int = K) -> dict:
    seeds, sigma = engine.top_k(k)
    return dict(top_k=(np.asarray(seeds).tolist(), sigma),
                sigma=np.asarray(engine.sigma(SIGMA_SETS)).tolist(),
                gains=np.asarray(engine.marginal_gains([3])).tolist(),
                extension=np.asarray(engine.best_extension([3], 2)).tolist())


SIGMA_SETS = [[1, 2], [5, 50, 99], [7]]
POOL_BATCHES = 12


def pool_config(diffusion: str, backend: str, frontier: str = "dense"):
    from repro_torch.serve.influence import PoolConfig
    return PoolConfig(max_batches=32, spec=SamplerSpec(
        diffusion=diffusion, backend=backend, num_colors=COLORS,
        master_seed=3, frontier=frontier, frontier_capacity=16, tile_size=T))


def sharded_serve_world(rank, dev, cases: list, ckpt_root: str,
                        ref_dirs: dict) -> list:
    """Per case (mesh shape, diffusion, frontier): a `ShardedSketchStore`
    of 12 batches (data_parallel on a (D, 1) mesh, graph_parallel when the
    model axis is split) and its `DistributedQueryEngine`'s answers; the
    pool saved and restored onto every other shape of the world's size;
    the reference's snapshot in ``ref_dirs[diffusion]`` restored onto the
    mesh, and the rank's (slots, rows) block of it; answers after
    ``refresh(0.5)``."""
    import os

    from repro_torch.serve.distributed import (DistributedQueryEngine,
                                               ShardedSketchStore)

    g = graph(dev)
    out = []
    for i, case in enumerate(cases):
        shape = tuple(case["shape"])
        mesh = make_mesh(shape, ("data", "model"), device=dev)
        backend = "graph_parallel" if shape[1] > 1 else "data_parallel"
        cfg = pool_config(case["diffusion"], backend, case["frontier"])
        store = ShardedSketchStore(g, cfg, mesh)
        store.ensure(POOL_BATCHES)
        engine = DistributedQueryEngine(store)
        res = dict(case, masks=_masks(store.batches),
                   block=tuple(store.visited_stack().shape),
                   answers=_answers(engine))
        ckpt = os.path.join(ckpt_root, f"case{i}")
        store.save(ckpt)
        res["restored"] = {}
        for other in cases:
            shape2 = tuple(other["shape"])
            mesh2 = make_mesh(shape2, ("data", "model"), device=dev)
            back2 = "graph_parallel" if shape2[1] > 1 else "data_parallel"
            restored = ShardedSketchStore.restore(
                ckpt, g, pool_config(case["diffusion"], back2,
                                     case["frontier"]), mesh2)
            res["restored"][str(shape2)] = (
                _answers(DistributedQueryEngine(restored)),
                _masks(restored.batches))
        from_ref = ShardedSketchStore.restore(ref_dirs[case["diffusion"]], g,
                                              cfg, mesh)
        res["from_reference"] = (_answers(DistributedQueryEngine(from_ref)),
                                 _masks(from_ref.batches), from_ref.epoch,
                                 from_ref.next_batch_index)
        # The rank's block of the restored pool: its slots, its rows.
        per, lo = from_ref.slots_per_shard, from_ref.slot_offset
        rlo, rows = from_ref.row_offset, from_ref.rows_per_shard
        placed = from_ref.visited_stack()
        want = np.zeros((per, rows, 2), np.uint32)
        part = res["masks"][lo:lo + per, rlo:rlo + rows]
        want[:part.shape[0], :part.shape[1]] = part
        res["placed_block"] = (
            tuple(placed.shape), placed.device.type,
            bool(np.array_equal(convert.masks_to_numpy(placed), want)))
        # Per-shard budget: 2.5 of a rank's (V/M)-row slots a rank.
        per_slot = -(-store.bytes_per_batch // store.row_shards)
        budget = dataclasses.replace(cfg, memory_budget_mb=2.5 * per_slot
                                     / 2 ** 20)
        res["capacity"] = ShardedSketchStore(g, budget, mesh).capacity
        res["refresh_slots"] = store.refresh(0.5)
        res["after_refresh"] = _answers(engine)
        res["staged_bytes"] = mesh.staged_bytes
        out.append(res)
    return out


# ------------------------------------------------- the mesh front end
FRONT_GRAPH = dict(n=150, degree=5.0, prob=0.25, seed=17)
FRONT_SEED, FRONT_BATCHES = 9, 4
FRONT_TIMEOUT_S = 10.0      # the mesh's collective timeout
KEEPALIVE_S = 1.0           # well under it
IDLE_GAP_S = 12.0           # longer than it
STACKED = [[0, 2, 5], [1], []]


def front_graph(dev="cpu"):
    return csr.dedupe(generators.powerlaw_cluster(
        FRONT_GRAPH["n"], FRONT_GRAPH["degree"], prob=FRONT_GRAPH["prob"],
        seed=FRONT_GRAPH["seed"], device=dev))


def front_spec(backend: str) -> SamplerSpec:
    return SamplerSpec(backend=backend, num_colors=COLORS,
                       master_seed=FRONT_SEED, tile_size=T)


def _idle(engine, lone: list) -> dict:
    """Rank 0: a front end that refuses an oversized submit, is left idle
    for longer than the mesh's timeout, then answers one query."""
    import time

    from repro_torch.serve.distributed import AsyncFrontEnd, MeshLeader
    from repro_torch.serve.influence import MicroBatcher

    with MeshLeader(engine, keepalive_s=KEEPALIVE_S) as leader:
        with AsyncFrontEnd(MicroBatcher(leader), default_deadline=0.05) as fe:
            try:
                fe.submit_sigma(list(range(engine.max_seeds + 1)))
                oversized = None
            except ValueError as e:
                oversized = str(e)
            t0 = time.monotonic()
            time.sleep(IDLE_GAP_S)
            gap = time.monotonic() - t0
            fut = fe.submit_sigma(lone)
            value = fut.result(timeout=30)
    return dict(gap_s=gap, value=value, version=fut.pool_version,
                oversized=oversized, messages=leader.stats.messages)


def mesh_frontend_world(rank, dev, ckpt: str) -> dict:
    """One 2×2 world (collective timeout ``FRONT_TIMEOUT_S``) on a
    graph_parallel pool: the GPU smoke's front-end session
    (`launch.mesh_smoke._front_end`: rank 0 leads, the others follow, then
    every query asked directly after ``STOP``); a second session that
    refuses an oversized submit and idles for longer than the timeout;
    and the mesh samplers' ``sample_stacked``."""
    from repro_torch.launch import mesh_smoke
    from repro_torch.serve.distributed import (DistributedQueryEngine,
                                               ShardedSketchStore, follow)
    from repro_torch.serve.influence import PoolConfig

    mesh = make_mesh((2, 2), ("data", "model"), device=dev,
                     timeout_s=FRONT_TIMEOUT_S)
    g = front_graph(dev)
    store = ShardedSketchStore(g, PoolConfig(
        max_batches=8, spec=front_spec("graph_parallel")), mesh)
    mesh.reset_stats()
    sent = mesh.broadcast(torch.full((3,), rank + 5, dtype=torch.int32),
                          axes=mesh.axis_names)
    out = {"rank": rank, "broadcast": (sent.tolist(), {
        ax: dict(v) for ax, v in mesh.stats.items()})}
    store.ensure(FRONT_BATCHES)
    out["f"] = mesh_smoke._front_end(store, mesh, ckpt)
    engine = DistributedQueryEngine(store)
    if rank == 0:
        out["idle"] = _idle(engine, mesh_smoke._fe_queries(g.num_vertices)[0])
    else:
        out["idle_follow"] = follow(engine).messages
    out["stacked"] = {}
    for backend in ("graph_parallel", "data_parallel"):
        sampler = make_sampler(g, front_spec(backend), mesh)
        out["stacked"][backend] = [
            convert.masks_to_numpy(sampler.sample_stacked(idx))
            for idx in STACKED]
    return out


def moe_cfg(job: dict):
    """The port's float32 config of a ``make_torch_golden.moe_reference``
    job."""
    get = registry.smoke if job.get("smoke") else registry.get
    return dataclasses.replace(get(job["arch"]),
                               **dict(job.get("overrides", {}),
                                      dtype="float32"))


def _torch_tree(tree: dict, dev) -> dict:
    return {k: _torch_tree(v, dev) if isinstance(v, dict)
            else torch.from_numpy(v).to(dev) for k, v in tree.items()}


def moe_world(rank, dev, jobs: list) -> dict:
    """On one world: `Mesh.all_to_all` over ``model`` (block ``j`` sent to
    position ``j`` tagged with its sender), then per job the expert-parallel
    MoE — `mlp._moe_forward_a2a` on this rank's token block and only its
    experts (drawn alone by `numpy_moe`), the blocks gathered back, and
    `mlp.moe_forward` with the mesh on the whole layer — with the calls
    and bytes the ``model`` axis counted."""
    out: dict = {"rank": rank, "jobs": []}
    for job in jobs:
        cfg = moe_cfg(job)
        mesh = make_mesh(job["shape"], ("data", "model"), device=dev)
        s, m = mesh.shape["model"], mesh.axis_index("model")
        sent = torch.stack([torch.tensor([rank, j, 7 * rank + j])
                            for j in range(s)]).to(dev)
        got = mesh.all_to_all(sent, "model")
        el = cfg.num_experts // s
        local = _torch_tree(model_init.numpy_moe(
            cfg, job["seed"], experts=range(m * el, (m + 1) * el)), dev)
        x = torch.from_numpy(model_init.numpy_moe_input(
            cfg, job["seed"], job["batch"], job["seq"])).to(dev)
        mesh.reset_stats()
        block, aux = mlp._moe_forward_a2a(local, mlp.token_block(x, mesh),
                                          cfg, mesh)
        stats = dict(mesh.stats["model"])
        whole = mlp.gather_tokens(block, mesh)
        full = _torch_tree(model_init.numpy_moe(cfg, job["seed"]), dev)
        via, via_aux = mlp.moe_forward(full, x, cfg, mesh)
        out["jobs"].append(dict(
            job, sent=sent.cpu().numpy(), got=got.cpu().numpy(),
            out=whole.cpu().numpy(), aux=float(aux), via=via.cpu().numpy(),
            via_aux=float(via_aux), model_stats=stats))
    return out


def dp_grads(job: dict, rank: int) -> dict:
    """``make_torch_golden.dp_grads``: this rank's gradient leaves."""
    rng = np.random.default_rng((job["seed"], rank))
    return {name: (rng.standard_normal(shape) * (rank + 1)).astype(
        np.float32) for name, shape in job["shapes"].items()}


def dp_world(rank, dev, job: dict) -> dict:
    """On a ``("data",)`` world: `compress.compressed_psum` of this rank's
    `dp_grads`, then, with ``job["steps"]``, the reference's convergence
    run — the smoke llama's data-parallel step (`train.dp_step`) exact and
    compressed from the same weights, ``job["batch"]`` sequences a step
    shared over the ranks — returning each run's losses."""
    from repro_torch.train.dp_step import make_dp_train_step

    n = job["devices"]
    mesh = make_mesh((n,), ("data",), device=dev)
    grads = {k: torch.from_numpy(v).to(dev)
             for k, v in dp_grads(job, rank).items()}
    mean, res = compress.compressed_psum(grads, mesh, "data")
    out = {"rank": rank, "mean": {k: v.cpu().numpy() for k, v in mean.items()},
           "residual": {k: v.cpu().numpy() for k, v in res.items()}}
    if job.get("steps"):
        cfg = registry.smoke("llama3.2-3b")
        data = SyntheticLM(cfg, job["batch"], 32, seed=4)
        for compressed in (False, True):
            params = model.trainable(model.init_params(cfg, 0, dev))
            opt = adamw.init(params)
            step, init_res = make_dp_train_step(
                cfg, lambda s: 1e-3, mesh, compressed=compressed)
            err = init_res(params)
            losses = []
            for s in range(job["steps"]):
                b = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                     for k, v in data.batch_at(s).items()}
                params, opt, err, m = step(params, opt, err, b)
                losses.append(float(m["loss"]))
            out["compressed" if compressed else "exact"] = losses
    return out


def train_mesh_world(rank, dev, jobs: list, shard_checks: list = ()) -> list:
    """`launch.mesh_smoke.rank_train_mesh` (the card's golden phase's rank
    program) on a CPU world, `rank_shard_init` of ``shard_checks`` on a
    2×2 mesh (the card's shards and gradients check), plus
    `Mesh.reduce_scatter` over each axis of a 2-axis mesh against an
    all-reduce and this rank's slice."""
    from repro_torch.launch import mesh_smoke

    out = mesh_smoke.rank_train_mesh(rank, dev, jobs)
    shards = mesh_smoke.rank_shard_init(rank, dev, list(shard_checks),
                                        (2, 2), ("data", "model"))
    mesh = make_mesh((2, 2), ("data", "model"), device=dev)
    checks = {}
    for axis in mesh.axis_names:
        x = torch.from_numpy(np.random.default_rng((rank, 3)).standard_normal(
            (6, 5)).astype(np.float32))
        got = mesh.reduce_scatter(x, axis)
        i = mesh.axis_index(axis)
        want = mesh.psum(x, axis)[i * 3:(i + 1) * 3]
        checks[axis] = (got.numpy(), want.numpy(), mesh.stats[axis]["calls"])
    return {"jobs": out, "reduce_scatter": checks, "shards": shards}


RESTART_KW = dict(batch=8, seq_len=32, steps=4, ckpt_every=1, lr=1e-3,
                  log_every=100, print_fn=lambda *a: None)


def _full_state(res) -> dict:
    """A `loop.TrainResult`'s parameters and moments gathered to full
    size (every rank takes part), as numpy."""
    lay = res.params.fsdp
    named = dict(res.params.named_parameters())
    return {f"{what}/{k}": lay.full(k, t.detach()).cpu().numpy()
            for what, tree in (("params", named), ("m", res.opt_state.m),
                               ("v", res.opt_state.v))
            for k, t in tree.items()}


def train_restart_world(rank, dev, root: str) -> dict:
    """The smoke llama on a 2×2 mesh through `train.loop`: 4 steps
    checkpointed every step (``clean``); the same crashed after its
    second step (index 1, whose checkpoint is written first) and
    restarted from step 2 (``crashed``); and 4 steps resumed from the
    one-device checkpoint the test wrote at step 2 under ``root/one``
    (``from_one``).  Returns each run's losses, where it resumed, and on
    rank 0 its parameters and moments at full size."""
    import os

    from repro_torch.train import loop

    cfg = registry.smoke("llama3.2-3b")
    mesh = make_mesh((2, 2), ("data", "model"), device=dev, timeout_s=120)
    runs = {
        "clean": loop.train(cfg, checkpoint_dir=os.path.join(root, "clean"),
                            device=dev, mesh=mesh, **RESTART_KW),
        "crashed": loop.train_with_restarts(
            cfg, checkpoint_dir=os.path.join(root, "crashed"),
            crash_schedule=(1,), device=dev, mesh=mesh, **RESTART_KW),
        "from_one": loop.train(cfg, checkpoint_dir=os.path.join(root, "one"),
                               device=dev, mesh=mesh, **RESTART_KW)}
    out = {"rank": rank}
    for name, res in runs.items():
        state = _full_state(res)
        out[name] = dict(losses=res.losses, resumed_from=res.resumed_from,
                         step=int(res.opt_state.step),
                         state=state if rank == 0 else None)
    return out


def dryrun_stats_world(rank, dev, cfgs: list, train: tuple,
                       serve: tuple) -> list:
    """For each of ``cfgs``, the collectives that one train step and one
    prefill plus one decode step send on a 2×2 mesh, by axis
    (``Mesh.stats`` of each, reset before it): ``train`` (batch, length)
    of seeded tokens through `train.step.make_train_step` on the config's
    shards; ``serve`` (batch, prompt, cache length) through
    `serve.engine.prefill` and one `models.decode.decode_step`
    (`test_torch_dryrun.py` holds them against the dry-run's counts)."""
    from repro_torch.models import decode as dec
    from repro_torch.serve import engine
    from repro_torch.train.step import make_train_step

    mesh = make_mesh((2, 2), ("data", "model"), device=dev)
    out = []
    for cfg in cfgs:
        layout = model.layout_on(mesh, cfg)
        params = layout.attach(model.trainable(model.init_params(
            cfg, 0, dev, keep=layout.local)))
        gen = torch.Generator().manual_seed(1)
        b, L = train
        tokens = torch.randint(0, cfg.vocab_size, (b, L), generator=gen)
        opt = adamw.init(params, torch.float32)
        step = make_train_step(cfg, lambda s: 1e-3, mesh=mesh)
        mesh.reset_stats()
        step(params, opt, {"tokens": tokens, "labels": tokens})
        res = {"train": {a: dict(v) for a, v in mesh.stats.items()}}
        for p in params.parameters():
            p.requires_grad_(False)
        b, prompt, max_len = serve
        tokens = torch.randint(0, cfg.vocab_size, (b, prompt), generator=gen)
        with torch.no_grad():
            mesh.reset_stats()
            logits, caches, _ = engine.prefill(
                params, cfg, {"tokens": tokens}, max_len, mesh)
            res["prefill"] = {a: dict(v) for a, v in mesh.stats.items()}
            mesh.reset_stats()
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            dec.decode_step(params, cfg, caches, tok, prompt, mesh)
            res["decode"] = {a: dict(v) for a, v in mesh.stats.items()}
        out.append(res)
    return out


def members_world(rank, dev) -> dict:
    """Sub-meshes of one world of 4 (`comm.Mesh(members=...)`): a (1, 2)
    mesh on ranks 1 and 3 and a (1, 3) one on ranks 0-2,
    their collectives among the members alone while the others stand by;
    then the whole world's (2, 2) mesh still works."""
    out = {"rank": rank}
    pair = make_mesh((1, 2), ("data", "model"), device=dev, members=(1, 3))
    out["pair"] = dict(member=pair.member, rank=pair.rank)
    if pair.member:
        x = torch.tensor([float(rank)])
        out["pair"].update(
            gathered=pair.all_gather(x, "model").tolist(),
            total=float(pair.psum(x, ("data", "model"))),
            sent=pair.ppermute(x, "model", 1).tolist(),
            index=pair.axis_index("model"))
        pair.barrier()
    trio = make_mesh((1, 3), ("data", "model"), device=dev,
                     members=(0, 1, 2))
    out["trio"] = dict(member=trio.member, rank=trio.rank)
    if trio.member:
        out["trio"]["gathered"] = trio.all_gather(
            torch.tensor([rank]), "model").tolist()
        out["trio"]["broadcast"] = trio.broadcast(
            torch.tensor([rank + 10]), axes=("data", "model")).tolist()
    whole = make_mesh((2, 2), ("data", "model"), device=dev)
    out["whole"] = float(whole.psum(torch.tensor([1.0]), ("data", "model")))
    out["refused"] = []
    for members in ((2, 1), (0, 0), (0, 4)):
        try:
            make_mesh((1, 2), ("data", "model"), device=dev, members=members)
        except ValueError:
            out["refused"].append(members)
    return out
