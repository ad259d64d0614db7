"""Port ≡ reference for pool persistence: the checkpoint manager's layout,
`SketchStore.save` / `restore` across the two packages in both directions
(masks, roots, indices, epochs, edge visits and all five counters bit for
bit), snapshots from before streaming, and the diffusion and colour guards."""
import json
import os

import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jmanager
from repro.graph import csr as jcsr
from repro.graph import generators as jgen
from repro.sampling import SamplerSpec as JSpec
from repro.serve.influence import PoolConfig as JPoolConfig
from repro.serve.influence import SketchStore as JStore
from repro_torch import convert
from repro_torch.checkpoint import manager as tmanager
from repro_torch.graph import csr as tcsr
from repro_torch.graph import generators as tgen
from repro_torch.sampling import SamplerSpec as TSpec
from repro_torch.serve.influence import PoolConfig as TPoolConfig
from repro_torch.serve.influence import SketchStore as TStore

# pytest-xdist runs several workers on the machine's cores; one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing them.
torch.set_num_threads(1)


def _graphs(n=200, seed=13, dedupe=True):
    gj = jgen.powerlaw_cluster(n, 6.0, prob=0.25, seed=seed)
    gt = tgen.powerlaw_cluster(n, 6.0, prob=0.25, seed=seed, device="cpu")
    if dedupe:
        gj, gt = jcsr.dedupe(gj), tcsr.dedupe(gt)
    return gj, gt


def _spec_kw(diffusion="ic", backend="dense", frontier="dense"):
    return dict(diffusion=diffusion, backend=backend, num_colors=64,
                master_seed=3, frontier=frontier)


def _jstore(gj, batches=6, **kw):
    s = JStore(gj, JPoolConfig(max_batches=32, spec=JSpec(**_spec_kw(**kw))))
    s.ensure(batches)
    s.refresh(0.34)                       # mixed epochs, indices past B
    return s


def _tstore(gt, batches=6, **kw):
    s = TStore(gt, TPoolConfig(max_batches=32, spec=TSpec(**_spec_kw(**kw))))
    s.ensure(batches)
    s.refresh(0.34)
    return s


def _assert_same_pool(jstore, tstore):
    np.testing.assert_array_equal(
        convert.masks_to_numpy(tstore.visited_stack()),
        np.asarray(jstore.visited_stack()))
    assert tstore.version == jstore.version
    assert (tstore.epoch, tstore.next_batch_index, tstore.master_seed,
            tstore.num_colors, tstore.graph_epoch) == \
        (jstore.epoch, jstore.next_batch_index, jstore.master_seed,
         jstore.num_colors, jstore.graph_epoch)
    assert tstore.batch_epochs == jstore.batch_epochs
    for a, b in zip(jstore.batches, tstore.batches):
        assert a.batch_index == b.batch_index
        np.testing.assert_array_equal(np.asarray(a.roots), b.roots)
        assert (a.fused_edge_visits, a.unfused_edge_visits) == \
            (b.fused_edge_visits, b.unfused_edge_visits)


# ------------------------------------------------------------- the manager
def test_manager_round_trip_keep_and_manifest(tmp_path):
    tree = {"b": np.arange(6, dtype=np.int64).reshape(2, 3),
            "a": {"z": torch.tensor([1.5, 2.5]),
                  "y": [np.uint32([7, 2 ** 32 - 1]), np.zeros((0, 4))]}}
    for step in range(5):
        tmanager.save(str(tmp_path), step, tree, keep=3,
                      extra={"step_tag": step})
    assert tmanager.latest_step(str(tmp_path)) == 4
    assert sorted(os.listdir(tmp_path)) == [f"step_{s:08d}"
                                            for s in (2, 3, 4)]
    man = tmanager.read_manifest(str(tmp_path))
    assert man["step"] == 4 and man["extra"] == {"step_tag": 4}
    assert [e["path"] for e in man["leaves"]] == ["a/y/0", "a/y/1", "a/z",
                                                  "b"]
    back, step = tmanager.restore(str(tmp_path), tree, as_numpy=True)
    assert step == 4
    np.testing.assert_array_equal(back["a"]["y"][0], tree["a"]["y"][0])
    assert back["a"]["y"][0].dtype == np.uint32
    np.testing.assert_array_equal(back["b"], tree["b"])
    again, _ = tmanager.restore(str(tmp_path), tree, step=3)
    assert torch.equal(again["a"]["z"], tree["a"]["z"])
    with pytest.raises(ValueError, match="shape"):
        tmanager.restore(str(tmp_path), {**tree, "b": np.zeros(3)})
    with pytest.raises(KeyError, match="missing"):
        tmanager.restore(str(tmp_path), {"c": np.zeros(1)})
    with pytest.raises(FileNotFoundError):
        tmanager.read_manifest(str(tmp_path / "none"))
    writer = tmanager.save(str(tmp_path), 9, tree, blocking=False)
    writer.join()
    assert tmanager.latest_step(str(tmp_path)) == 9


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_manager_layout_is_the_references(tmp_path, writer):
    """Leaf order, paths, file names and dtypes match jax's flattening, so
    either package restores the other's checkpoint."""
    tree = {"visited": np.uint32([[1, 2 ** 31]]), "counters":
            np.int64([1, 2, 3]), "roots": np.int32([[4, 5]])}
    save = jmanager.save if writer == "repro" else tmanager.save
    save(str(tmp_path), 7, tree, extra={"kind": "x"})
    with open(tmp_path / "step_00000007" / "manifest.json") as f:
        man = json.load(f)
    assert [(e["path"], e["file"], e["dtype"]) for e in man["leaves"]] == [
        ("counters", "leaf_00000.npy", "int64"),
        ("roots", "leaf_00001.npy", "int32"),
        ("visited", "leaf_00002.npy", "uint32")]
    tback, _ = tmanager.restore(str(tmp_path), tree, as_numpy=True)
    jback, _ = jmanager.restore(str(tmp_path), tree, as_numpy=True)
    for k in tree:
        np.testing.assert_array_equal(tback[k], tree[k])
        np.testing.assert_array_equal(np.asarray(jback[k]), tree[k])


# ------------------------------------------------- the store, across packages
@pytest.mark.parametrize("diffusion,frontier", [("ic", "dense"),
                                                ("ic", "sparse"),
                                                ("lt", "sparse")])
@pytest.mark.parametrize("direction", ["repro_to_torch", "torch_to_repro"])
def test_snapshot_crosses_packages_bit_for_bit(tmp_path, direction,
                                               diffusion, frontier):
    gj, gt = _graphs()
    kw = dict(diffusion=diffusion, frontier=frontier)
    jstore, tstore = _jstore(gj, **kw), _tstore(gt, **kw)
    jstore.graph_epoch = tstore.graph_epoch = 5
    _assert_same_pool(jstore, tstore)
    if direction == "repro_to_torch":
        jstore.save(str(tmp_path))
        back = TStore.restore(str(tmp_path), gt, TPoolConfig(
            spec=TSpec(**_spec_kw(**kw))))
        _assert_same_pool(jstore, back)
    else:
        tstore.save(str(tmp_path))
        back = JStore.restore(str(tmp_path), gj, JPoolConfig(
            spec=JSpec(**_spec_kw(**kw))))
        _assert_same_pool(back, tstore)
    assert back.spec.diffusion == diffusion
    # Both continue on the same RNG streams after the round trip.
    assert back.refresh(0.5) == (jstore if direction == "torch_to_repro"
                                 else tstore).refresh(0.5)


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_four_counter_snapshot_restores_graph_epoch_zero(tmp_path,
                                                         monkeypatch, writer):
    """A snapshot from before streaming carries 4 counters; it restores
    with graph epoch 0 in the port, whichever package wrote it."""
    gj, gt = _graphs()
    store = _jstore(gj, batches=2) if writer == "repro" \
        else _tstore(gt, batches=2)
    store.graph_epoch = 7
    cls = type(store)
    orig_tree = cls._tree

    def legacy_tree(self):
        tree = orig_tree(self)
        tree["counters"] = tree["counters"][:4]
        return tree

    monkeypatch.setattr(cls, "_tree", legacy_tree)
    store.save(str(tmp_path))
    monkeypatch.undo()
    back = TStore.restore(str(tmp_path), gt,
                          TPoolConfig(spec=TSpec(**_spec_kw())))
    assert back.graph_epoch == 0
    assert back.version == (0, store.epoch, len(store.batches))


@pytest.mark.parametrize("saved,wanted", [("ic", "lt"), ("lt", "ic")])
def test_restore_refuses_a_diffusion_mismatch(tmp_path, saved, wanted):
    """An IC pool is never served as LT, nor the reverse; a matching spec
    restores bit for bit and keeps the spec."""
    _, gt = _graphs()
    store = _tstore(gt, batches=2, diffusion=saved)
    store.save(str(tmp_path))
    with pytest.raises(ValueError, match="diffusion"):
        TStore.restore(str(tmp_path), gt, TPoolConfig(
            spec=TSpec(**_spec_kw(diffusion=wanted))))
    back = TStore.restore(str(tmp_path), gt, store.config)
    assert back.spec == store.spec
    assert torch.equal(back.visited_stack(), store.visited_stack())


def test_restore_rejects_a_colour_mismatch(tmp_path):
    _, gt = _graphs()
    _tstore(gt, batches=2).save(str(tmp_path))
    with pytest.raises(ValueError, match="colors"):
        TStore.restore(str(tmp_path), gt, TPoolConfig(num_colors=128))


def test_manifest_records_the_sampler_spec(tmp_path):
    """The manifest's spec is the reference's dict: each package reads the
    other's."""
    _, gt = _graphs()
    spec = TSpec(diffusion="lt", num_colors=64, master_seed=1,
                 frontier="sparse", tile_size=64)
    store = TStore(gt, TPoolConfig(spec=spec))
    store.ensure(1)
    store.save(str(tmp_path))
    extra = jmanager.read_manifest(str(tmp_path))["extra"]
    assert extra["kind"] == "sketch_pool"
    assert JSpec.from_manifest(extra["sampler_spec"]) == JSpec(
        diffusion="lt", num_colors=64, master_seed=1, frontier="sparse",
        tile_size=64)
    assert TSpec.from_manifest({**extra["sampler_spec"], "later": 1}) == spec
    assert TSpec.from_manifest(JSpec(backend="kernel").to_manifest()) == \
        TSpec(backend="kernel")


def test_restore_adopts_the_snapshots_master_seed(tmp_path):
    """The reference's restore takes master_seed from the counters; so
    does the port's, in the config and its spec."""
    _, gt = _graphs()
    store = _tstore(gt, batches=2)
    store.save(str(tmp_path))
    back = TStore.restore(str(tmp_path), gt, TPoolConfig(num_colors=64))
    assert back.master_seed == 3 and back.spec.master_seed == 3
    assert back.config.with_master_seed(4).spec.master_seed == 4
