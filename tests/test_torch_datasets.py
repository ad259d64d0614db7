"""Port ≡ reference: the Table-1 graphs (`graph/datasets.py`), the
`erdos_renyi` and `rmat` generators, `csr.uniform_probs` and
`tiles.tile_stats` — every array bit for bit."""
import gzip

import numpy as np
import pytest
import torch

from repro.core import tiles as jtiles
from repro.graph import csr as jcsr
from repro.graph import datasets as jds
from repro.graph import generators as jgen
from repro_torch.core import tiles as ttiles
from repro_torch.graph import csr as tcsr
from repro_torch.graph import datasets as tds
from repro_torch.graph import generators as tgen

# pytest-xdist runs several workers on the machine's cores; one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing them.
torch.set_num_threads(1)


def _assert_graph_equal(gj, gt):
    assert (gj.num_vertices, gj.num_edges, gj.padded_edges) == \
        (gt.num_vertices, gt.num_edges, gt.padded_edges)
    for f in ("indptr", "src", "dst", "prob"):
        np.testing.assert_array_equal(np.asarray(getattr(gj, f)),
                                      getattr(gt, f).numpy(), err_msg=f)


@pytest.mark.parametrize("kw", [
    dict(n=400, avg_deg=8.0, seed=11),              # tests/test_graph.py
    dict(n=400, avg_deg=8.0, seed=11, prob=0.3),
    dict(n=1000, avg_deg=3.5, seed=2, prob=(0.1, 0.6)),
])
def test_erdos_renyi_matches_reference(kw):
    _assert_graph_equal(jgen.erdos_renyi(**kw),
                        tgen.erdos_renyi(**kw, device="cpu"))


@pytest.mark.parametrize("kw", [
    dict(scale=9, avg_deg=8.0, seed=11),            # tests/test_graph.py
    dict(scale=9, avg_deg=8.0, seed=11, prob=0.2),
    dict(scale=7, avg_deg=4.0, seed=3, a=0.45, b=0.15, c=0.15),
])
def test_rmat_matches_reference(kw):
    _assert_graph_equal(jgen.rmat(**kw), tgen.rmat(**kw, device="cpu"))


@pytest.mark.parametrize("args", [(0, 500), (5, 77, 0.2, 0.9)])
def test_uniform_probs_matches_reference(args):
    seed, *rest = args
    want = jcsr.uniform_probs(np.random.default_rng(seed), *rest)
    got = tcsr.uniform_probs(np.random.default_rng(seed), *rest)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_table1_is_the_reference_table():
    assert tds.TABLE1 == jds.TABLE1
    assert list(tds.TABLE1) == list(jds.TABLE1)


def test_table1_clone_matches_reference_in_one_process():
    """``hash(name)`` salts the seed per process: inside one process the
    two clones are the same graph."""
    _assert_graph_equal(jds.table1_clone("web-Google", 0.01),
                        tds.table1_clone("web-Google", 0.01, device="cpu"))
    _assert_graph_equal(
        jds.table1_clone("wiki-topcats", 0.00001, prob=0.1, seed=4),
        tds.table1_clone("wiki-topcats", 0.00001, prob=0.1, seed=4,
                         device="cpu"))


def test_table1_clone_unknown_name():
    with pytest.raises(KeyError, match="unknown Table-1 graph"):
        jds.table1_clone("not-a-graph")
    with pytest.raises(KeyError, match="unknown Table-1 graph"):
        tds.table1_clone("not-a-graph", device="cpu")


def _write_snap(path, rows, gz):
    text = "# Directed graph\n# FromNodeId\tToNodeId\n" + "".join(
        f"{a}\t{b}\n" for a, b in rows)
    if gz:
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        path.write_text(text)


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("kw", [dict(), dict(num_vertices=60, prob=0.25),
                                dict(prob=(0.2, 0.4), seed=9)])
def test_load_snap_round_trip(tmp_path, gz, kw):
    rows = np.random.default_rng(1).integers(0, 50, (300, 2))
    rows = rows[rows[:, 0] != rows[:, 1]]
    path = tmp_path / ("g.txt.gz" if gz else "g.txt")
    _write_snap(path, rows, gz)
    gj = jds.load_snap(str(path), **kw)
    gt = tds.load_snap(str(path), **kw, device="cpu")
    _assert_graph_equal(gj, gt)
    assert gt.num_edges == len(rows)


@pytest.mark.parametrize("ext", [".txt", ".txt.gz"])
def test_table1_clone_reads_snap_dir(tmp_path, ext):
    rows = [(0, 1), (1, 2), (2, 0), (5, 3)]
    _write_snap(tmp_path / f"web-Google{ext}", rows, ext.endswith(".gz"))
    gj = jds.table1_clone("web-Google", snap_dir=str(tmp_path), seed=3)
    gt = tds.table1_clone("web-Google", snap_dir=str(tmp_path), seed=3,
                          device="cpu")
    _assert_graph_equal(gj, gt)
    assert gt.num_vertices == 6


@pytest.mark.parametrize("n,tile,pad", [(300, 128, None), (700, 64, None),
                                        (300, 128, 12)])
def test_tile_stats_matches_reference(n, tile, pad):
    gj = jcsr.dedupe(jgen.powerlaw_cluster(n, 6.0, prob=0.3, seed=n))
    gt = tcsr.from_edges(np.asarray(gj.src)[:gj.num_edges],
                         np.asarray(gj.dst)[:gj.num_edges],
                         np.asarray(gj.prob)[:gj.num_edges], n, device="cpu")
    want = jtiles.tile_stats(jtiles.from_graph(gj, tile, pad_tiles_to=pad))
    got = ttiles.tile_stats(ttiles.from_graph(gt, tile, pad_tiles_to=pad))
    assert got == want
    assert set(got) == {"num_tiles", "possible_tiles", "tile_fill_fraction",
                        "occupancy"}
